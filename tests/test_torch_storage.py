"""The port's object-store adapter and stdlib SigV4 client against the JAX
package on the CPU: the fake-boto3 cases of ``tests/test_storage.py`` (the
credentials from the environment, the endpoint, the streaming body under
tarfile, paginated glob listing) and the wire cases over
``tests/loopback_s3.py`` (a loopback server that re-derives every
signature), each answered as JAX answers; the canonical request, the
signature and the signed headers equal JAX's at a fixed clock.
"""

import datetime
import io
import json
import sys
import tarfile

import pytest

from merlin_tpu.data import s3http as j_s3http
from merlin_tpu.data import storage as j_storage

from merlin_tpu_torch.data import registry as t_registry
from merlin_tpu_torch.data import s3http as t_s3http
from merlin_tpu_torch.data import shards as t_shards
from merlin_tpu_torch.data import storage as t_storage

from test_storage import _FakeClient


def _clear_caches():
    t_storage._CLIENT_CACHE.clear()
    j_storage._CLIENT_CACHE.clear()


@pytest.fixture()
def fake_s3(monkeypatch):
    import types

    store, recorded = {}, {}
    fake = types.ModuleType("boto3")

    class Session:
        def __init__(self, **kw):
            recorded["session"] = kw

        def client(self, service, endpoint_url=None):
            recorded["endpoint_url"] = endpoint_url
            return _FakeClient(store, recorded)

    fake.Session = Session
    monkeypatch.setitem(sys.modules, "boto3", fake)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKTEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "SECRET")
    monkeypatch.setenv("AWS_ENDPOINT_URL", "https://oss.example")
    _clear_caches()
    yield store, recorded
    _clear_caches()


def _tar_bytes(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_smart_open_s3_credentials_and_bytes(fake_s3):
    store, recorded = fake_s3
    store[("bkt", "dir/a.json")] = b'{"x": 1}'
    with t_storage.smart_open("s3://bkt/dir/a.json", "r") as f:
        assert json.load(f) == {"x": 1}
    assert recorded["session"]["aws_access_key_id"] == "AKTEST"
    assert recorded["session"]["aws_secret_access_key"] == "SECRET"
    assert recorded["endpoint_url"] == "https://oss.example"
    assert t_storage.s3_credentials() == j_storage.s3_credentials()


def test_smart_open_s3_tar_streaming(fake_s3):
    store, _ = fake_s3
    store[("bkt", "shards/s0.tar")] = _tar_bytes(
        [(f"s{i:03d}.{ext}", f"payload{i}".encode())
         for i in range(3) for ext in ("jpg", "txt")])
    samples = list(t_shards.indexed_tar_samples("s3://bkt/shards/s0.tar"))
    assert len(samples) == 3 and samples[0][1]["txt"] == b"payload0"
    from merlin_tpu.data.shards import indexed_tar_samples
    assert samples == list(indexed_tar_samples("s3://bkt/shards/s0.tar"))


def test_list_keys_glob_and_pagination(fake_s3):
    store, _ = fake_s3
    for i in range(5):
        store[("bkt", f"data/part-{i}.tar")] = b""
    store[("bkt", "data/readme.md")] = b""
    out = t_storage.list_keys("s3://bkt/data/part-*.tar")
    assert out == [f"s3://bkt/data/part-{i}.tar" for i in range(5)]
    assert out == j_storage.list_keys("s3://bkt/data/part-*.tar")


@pytest.mark.parametrize("pattern,want", [
    ("data/*.tar", ["data/a.tar"]),
    ("data/**.tar", ["data/a.tar", "data/sub/b.tar"]),
    ("data/?.tar", ["data/a.tar"]),
    ("data/**/a.tar", ["data/a.tar"]),
    ("data/**/b.tar", ["data/sub/b.tar"]),
    ("data/sub/b.tar", ["data/sub/b.tar"])])
def test_list_keys_glob_does_not_cross_slash(fake_s3, pattern, want):
    store, _ = fake_s3
    store[("bkt", "data/a.tar")] = b""
    store[("bkt", "data/sub/b.tar")] = b""
    got = t_storage.list_keys(f"s3://bkt/{pattern}")
    assert got == [f"s3://bkt/{k}" for k in want]
    assert got == j_storage.list_keys(f"s3://bkt/{pattern}")


@pytest.mark.parametrize("pattern", [
    "data/[]].tar", "data/[!x].tar", "data/[ab]/c.tar", "a/**/b/c.tar",
    "a/*/[", "x?y/**", "plain/key.tar"])
def test_glob_re_equals_jax(pattern):
    assert t_storage._glob_re(pattern).pattern == \
        j_storage._glob_re(pattern).pattern
    rx = t_storage._glob_re
    assert rx("data/[]].tar").match("data/].tar")
    assert rx("data/[!x].tar").match("data/a.tar")
    assert not rx("data/[!x].tar").match("data/x.tar")
    assert rx("a/**/b/c.tar").match("a/x/y/b/c.tar")
    assert not rx("a/**/b/c.tar").match("a/c.tar")


def test_registry_spec_expands_s3_glob(fake_s3):
    store, _ = fake_s3
    for i in range(3):
        store[("bkt", f"laion/{i:05d}.tar")] = b""
    spec = t_registry.WebdataSpec(path="s3://bkt/laion/*.tar", size=10)
    assert spec.shard_list() == [
        f"s3://bkt/laion/{i:05d}.tar" for i in range(3)]


def test_smart_open_local_passthrough(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("hello")
    with t_storage.smart_open(str(p), "r") as f:
        assert f.read() == "hello"


def test_smart_open_s3_write_rejected(fake_s3):
    with pytest.raises(NotImplementedError):
        t_storage.smart_open("s3://bkt/x", "wb")


def test_no_client_no_fsspec_raises(monkeypatch):
    """Neither boto3 nor credentials nor fsspec: the error says what to
    install, as JAX's."""
    monkeypatch.setitem(sys.modules, "boto3", None)
    monkeypatch.setitem(sys.modules, "fsspec", None)
    for name in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY"):
        monkeypatch.delenv(name, raising=False)
    _clear_caches()
    for mod in (t_storage, j_storage):
        with pytest.raises(RuntimeError, match="neither boto3 nor fsspec"):
            mod.smart_open("s3://bkt/k", "rb")


# --- the signature ----------------------------------------------------------

def test_sigv4_signature_and_canonical_request_equal_jax():
    args = ("GET", "/bkt/dir name/a+b c.txt",
            {"list-type": "2", "prefix": "laion/", "continuation-token": "2"},
            {"host": "127.0.0.1:9", "x-amz-date": "20260101T000000Z",
             "x-amz-content-sha256": t_s3http._EMPTY_SHA256,
             "x-amz-security-token": "  tok   123 "},
            ["host", "x-amz-date", "x-amz-content-sha256",
             "x-amz-security-token"], t_s3http._EMPTY_SHA256)
    creq = t_s3http.canonical_request(*args)
    assert creq == j_s3http.canonical_request(*args)
    sig = t_s3http.sigv4_signature("secret", "20260101", "us-east-1", "s3",
                                   creq)
    assert sig == j_s3http.sigv4_signature("secret", "20260101",
                                           "us-east-1", "s3", creq)
    assert len(sig) == 64


def test_signed_headers_equal_jax_at_a_fixed_clock(monkeypatch):
    fixed = datetime.datetime(2026, 3, 4, 5, 6, 7,
                              tzinfo=datetime.timezone.utc)

    class Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    headers = []
    for mod in (t_s3http, j_s3http):
        monkeypatch.setattr(mod.datetime, "datetime", Clock)
        client = mod.S3HttpClient("AK", "SK", session_token="tok",
                                  endpoint_url="http://localhost:9000/base",
                                  region="eu-west-1")
        headers.append(client._signed_headers(
            "GET", "/base/bkt/k y", {"prefix": "a b"}, {"Range": "bytes=1-2"}))
    assert headers[0] == headers[1]
    assert headers[0]["x-amz-date"] == "20260304T050607Z"
    assert "x-amz-security-token" in headers[0]["authorization"]


# --- the wire ---------------------------------------------------------------

@pytest.fixture()
def wire_s3(monkeypatch):
    from tests.loopback_s3 import LoopbackS3Server

    store = {}
    srv = LoopbackS3Server(store, "AKWIRE", "wire-secret",
                           session_token="tok-123")
    with srv:
        monkeypatch.setitem(sys.modules, "boto3", None)
        monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKWIRE")
        monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "wire-secret")
        monkeypatch.setenv("AWS_SESSION_TOKEN", "tok-123")
        monkeypatch.setenv("AWS_ENDPOINT_URL", srv.endpoint_url)
        _clear_caches()
        yield store, srv
        _clear_caches()


def test_wire_get_object_bytes_and_text(wire_s3):
    store, srv = wire_s3
    store[("bkt", "dir/a.json")] = b'{"x": 1}'
    with t_storage.smart_open("s3://bkt/dir/a.json", "rb") as f:
        assert f.read() == b'{"x": 1}'
    with t_storage.smart_open("s3://bkt/dir/a.json", "r") as f:
        assert f.read() == '{"x": 1}'
    assert ("GET", "/bkt/dir/a.json", {}) in srv.requests
    assert isinstance(t_storage._s3_client(), t_s3http.S3HttpClient)


def test_wire_tar_streaming_through_the_shard_reader(wire_s3):
    store, _ = wire_s3
    store[("bkt", "shards/000.tar")] = _tar_bytes(
        [("0.txt", b"alpha"), ("0.jpg", b"\xff\xd8beta"),
         ("1.txt", b"gamma")])
    got = list(t_shards.indexed_tar_samples("s3://bkt/shards/000.tar"))
    assert got == [(0, {"txt": b"alpha", "jpg": b"\xff\xd8beta",
                        "__key__": "0"}),
                   (1, {"txt": b"gamma", "__key__": "1"})]


def test_wire_list_keys_glob_pagination(wire_s3):
    store, srv = wire_s3
    for i in range(5):
        store[("bkt", f"laion/{i:05d}.tar")] = b"x"
    store[("bkt", "laion/readme.md")] = b"no"
    store[("bkt", "laion/sub/9.tar")] = b"no"
    got = t_storage.list_keys("s3://bkt/laion/*.tar")
    assert got == [f"s3://bkt/laion/{i:05d}.tar" for i in range(5)]
    lists = [q for m, p, q in srv.requests if q.get("list-type") == "2"]
    assert len(lists) >= 3
    assert all(q.get("prefix") == "laion/" for q in lists)
    assert got == j_storage.list_keys("s3://bkt/laion/*.tar")


def test_wire_bad_secret_rejected(wire_s3, monkeypatch):
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "WRONG")
    _clear_caches()
    store, _ = wire_s3
    store[("bkt", "k")] = b"data"
    with pytest.raises(OSError, match="403"):
        t_storage.smart_open("s3://bkt/k", "rb")


def test_wire_unsigned_session_token_rejected(wire_s3):
    store, srv = wire_s3
    store[("bkt", "k")] = b"data"
    no_token = t_s3http.S3HttpClient("AKWIRE", "wire-secret",
                                     endpoint_url=srv.endpoint_url)
    with pytest.raises(OSError, match="403"):
        no_token.get_object(Bucket="bkt", Key="k")


def test_wire_ranged_get(wire_s3):
    store, _ = wire_s3
    store[("bkt", "k")] = b"0123456789"
    resp = t_storage._s3_client().get_object(Bucket="bkt", Key="k",
                                             Range="bytes=3-6")
    assert resp["Body"].read() == b"3456"
    assert resp["ContentLength"] == 4
    resp["Body"].close()


def test_wire_special_chars_in_key(wire_s3):
    store, _ = wire_s3
    store[("bkt", "dir name/a+b c.txt")] = b"enc"
    with t_storage.smart_open("s3://bkt/dir name/a+b c.txt", "rb") as f:
        assert f.read() == b"enc"


def test_wire_annotations_json_through_conversation_loader(wire_s3):
    """The conversation set reads its annotations over the wire, as JAX's
    ``ConversationDataset._load_annotations`` does."""
    from merlin_tpu_torch.data.conversation_dataset import (
        ConversationDataset)

    store, _ = wire_s3
    ann = [{"conversations": [{"from": "human", "value": "q"},
                              {"from": "gpt", "value": "a"}]}]
    store[("bkt", "ann/conv.json")] = json.dumps(ann).encode()
    assert ConversationDataset._load_annotations("s3://bkt/ann/conv.json") \
        == ann
