"""The port's native tar loader (its own copy of the C++ source, built by the
host compiler into ``merlin_tpu_torch/native/build/``) against the Python
tar path and against JAX's ``NativeTarStream`` on the CPU: the same
multiset of samples as Python, the same order as JAX's loader with one
thread, infinite epochs, GNU long names, the cursor (exact with racing
threads, bit-exact with one, chained resumes replay nothing), the
``MERLIN_NATIVE_LOADER=0`` switch and ``shard_sample_stream``'s routes.
No timing is asserted here; the card phase measures the rates.
"""

import io
import logging
import os
import tarfile

import pytest

from merlin_tpu.data import native_loader as j_native

from merlin_tpu_torch.data import native_loader as t_native
from merlin_tpu_torch.data import shards as t_shards
from merlin_tpu_torch.data.native_loader import NativeTarStream

from test_native_loader import _make_shard


@pytest.fixture(scope="module", autouse=True)
def _built():
    assert t_native.native_available(), "the port's loader did not build"


def _shards(tmp_path, n_shards, n, tag):
    paths = []
    for t in range(n_shards):
        p = tmp_path / f"s{t}.tar"
        _make_shard(str(p), n=n, prefix=f"{tag}{t}")
        paths.append(str(p))
    return paths


def test_built_from_the_ports_own_source():
    here = os.path.dirname(os.path.dirname(os.path.abspath(
        t_native.__file__)))
    assert t_native._SOURCE == os.path.join(here, "native", "tar_loader.cc")
    assert os.path.dirname(t_native._SO_PATH) == os.path.join(
        here, "native", "build")
    assert os.path.exists(t_native._SO_PATH)
    assert os.path.getmtime(t_native._SO_PATH) >= \
        os.path.getmtime(t_native._SOURCE)
    assert t_native.build() == t_native._SO_PATH      # cached: no rebuild


def test_native_matches_python_sample_set(tmp_path):
    shard = tmp_path / "a.tar"
    _make_shard(str(shard), n=16)
    py_samples = list(t_shards.tar_to_samples(iter([str(shard)])))
    nat_samples = list(NativeTarStream([str(shard)], seed=1, max_epochs=1))
    assert len(nat_samples) == len(py_samples) == 16
    py_by_key = {s["__key__"]: s for s in py_samples}
    assert sorted(py_by_key) == sorted(s["__key__"] for s in nat_samples)
    for s in nat_samples:
        assert s == py_by_key[s["__key__"]]


def test_multiset_over_shards_equals_python(tmp_path):
    shards = _shards(tmp_path, 5, 7, "m")
    py = sorted(s["__key__"] for s in t_shards.tar_to_samples(iter(shards)))
    nat = sorted(s["__key__"] for s in NativeTarStream(
        shards, seed=4, n_threads=3, max_epochs=2))
    assert nat == sorted(py + py)


@pytest.mark.parametrize("seed", [0, 9])
def test_single_thread_order_equals_jax(tmp_path, seed):
    if not j_native.native_available():
        pytest.fail("JAX's native loader did not build")
    shards = _shards(tmp_path, 4, 5, "o")
    got = list(NativeTarStream(shards, seed=seed, n_threads=1, max_epochs=3))
    want = list(j_native.NativeTarStream(shards, seed=seed, n_threads=1,
                                         max_epochs=3))
    assert len(got) == 60
    assert got == want


def test_native_infinite_epochs(tmp_path):
    shard = tmp_path / "b.tar"
    _make_shard(str(shard), n=4)
    assert len(list(NativeTarStream([str(shard)], seed=7,
                                    max_epochs=3))) == 12


def test_native_long_names(tmp_path):
    shard = tmp_path / "long.tar"
    long_key = "k" * 120
    with tarfile.open(shard, "w", format=tarfile.GNU_FORMAT) as tf:
        info = tarfile.TarInfo(long_key + ".txt")
        info.size = 5
        tf.addfile(info, io.BytesIO(b"hello"))
    samples = list(NativeTarStream([str(shard)], seed=0, max_epochs=1))
    assert samples == [{"txt": b"hello", "__key__": long_key}]


def test_stream_uses_native_and_filters(tmp_path):
    shard = tmp_path / "c.tar"
    _make_shard(str(shard), n=8)
    stream = t_shards.shard_sample_stream([str(shard)], seed=3,
                                          use_native=True, sample_buffer=4,
                                          process_index=0, process_count=1)
    got = [next(stream) for _ in range(16)]
    assert all("txt" in s for s in got)
    assert {s["__key__"] for s in got} <= {f"{i:06d}" for i in range(8)}


def test_switch_off_falls_back_with_a_warning(tmp_path, monkeypatch, caplog):
    """``MERLIN_NATIVE_LOADER=0``: the Python stages, as JAX's fallback,
    and the fallback says so; ``use_native=True`` never falls back."""
    shard = tmp_path / "d.tar"
    _make_shard(str(shard), n=6)
    monkeypatch.setenv("MERLIN_NATIVE_LOADER", "0")
    assert not t_native.native_available()
    with caplog.at_level(logging.WARNING, logger="merlin_tpu_torch.data"):
        stream = t_shards.shard_sample_stream([str(shard)], sample_buffer=2,
                                              process_index=0,
                                              process_count=1)
    assert "native tar loader not used" in caplog.text
    python = t_shards.shard_sample_stream([str(shard)], sample_buffer=2,
                                          process_index=0, process_count=1,
                                          use_native=False)
    assert [next(stream)["__key__"] for _ in range(12)] == \
        [next(python)["__key__"] for _ in range(12)]
    monkeypatch.setattr(t_native, "load_library", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        next(t_shards.shard_sample_stream([str(shard)], use_native=True,
                                          process_index=0, process_count=1))


def test_native_cursor_resume_exact(tmp_path):
    """Racing threads: the restored stream yields exactly the samples not
    consumed, none lost, none replayed."""
    shards = _shards(tmp_path, 4, 6, "t")
    s = NativeTarStream(shards, seed=5, n_threads=2, max_epochs=1)
    seen = [next(s)["__key__"] for _ in range(8)]
    state = s.get_state()
    s.close()
    assert 0 <= state["shard_pos"] <= 4
    s2 = NativeTarStream.restore(shards, state, seed=5, n_threads=2,
                                 max_epochs=1)
    rest = [x["__key__"] for x in s2]
    s2.close()
    all_keys = {f"t{t}{i:06d}" for t in range(4) for i in range(6)}
    assert sorted(seen + rest) == sorted(all_keys)


def test_native_cursor_resume_bit_exact_single_thread(tmp_path):
    shards = _shards(tmp_path, 3, 5, "u")
    full = [x["__key__"] for x in NativeTarStream(
        shards, seed=9, n_threads=1, max_epochs=1)]
    s = NativeTarStream(shards, seed=9, n_threads=1, max_epochs=1)
    head = [next(s)["__key__"] for _ in range(7)]
    state = s.get_state()
    s.close()
    s2 = NativeTarStream.restore(shards, state, seed=9, n_threads=1,
                                 max_epochs=1)
    tail = [x["__key__"] for x in s2]
    s2.close()
    assert head == full[:7] and head + tail == full


def test_native_cursor_chained_resume_no_replay(tmp_path):
    """checkpoint -> resume -> checkpoint -> resume: the second cursor still
    counts the prefix the first run consumed; the cursors equal JAX's."""
    shards = _shards(tmp_path, 3, 5, "v")
    full = [x["__key__"] for x in NativeTarStream(
        shards, seed=11, n_threads=1, max_epochs=1)]
    states = {}
    for name, cls in (("torch", NativeTarStream),
                      ("jax", j_native.NativeTarStream)):
        s = cls(shards, seed=11, n_threads=1, max_epochs=1)
        a = [next(s)["__key__"] for _ in range(4)]
        st1 = s.get_state()
        s.close()
        s2 = cls.restore(shards, st1, seed=11, n_threads=1, max_epochs=1)
        b = [next(s2)["__key__"] for _ in range(4)]
        st2 = s2.get_state()
        s2.close()
        s3 = cls.restore(shards, st2, seed=11, n_threads=1, max_epochs=1)
        c = [x["__key__"] for x in s3]
        s3.close()
        assert a + b + c == full, name
        states[name] = (st1, st2)
    assert states["torch"] == states["jax"]
