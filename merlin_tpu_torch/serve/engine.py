"""Continuous-batching serving engine over a pooled paged KV cache
(counterpart of ``merlin_tpu/serve/engine.py``).

A fixed set of decode slots stays hot: requests admit into free slots,
every engine step decodes ALL active slots in one batched forward against
the shared paged cache, and slots free on EOS/length, so throughput
scales with occupancy instead of queueing.

Paging is vLLM-style: physical pages come from one shared ``PagePool``;
admission reserves only the prompt's pages, decode grows a sequence one
page at a time as it crosses page boundaries, and a request that cannot
grow preempts the youngest other request (its pages are released and it
re-queues for recompute). Physical page 0 is a trash page: idle slots'
table rows point at it, so the unconditional decode-step K/V write of a
masked slot can never land in a live request's pages.

Admission takes the whole prompt (prefill into a small identity-mapped
cache, then one scatter of its pages into the pool; the attention is the
flash kernel B2 on the card) or, with ``prefill_chunk=C``, fixed (1, C)
windows written straight into the slot's pool pages (paged window kernel
B6), interleaved with decode under a per-step window budget.
``prefill_chunk_min`` keeps short prompts on the whole-prompt route.
Decode steps attend through the paged decode kernel (B3, or B4 with
ALiBi); ``spec_draft=k`` replaces them with prompt-lookup verify windows
of k + 1 tokens (paged window kernel B5) that commit the accepted prefix.
On the card a plain greedy decode step (one rank, no speculation, no row
sampling) is captured once as a CUDA graph and replayed for every later
such step: the host issues one replay instead of every launch of the
layer stack. The graph reads and updates fixed device buffers, which the
engine's tokens, active mask, lengths and tables are copied into when
they change; everything else stays on the eager path. A step ends once
the card has finished all but the newest chunk, so a host that issues
faster than the card runs never queues an admission behind more than one
chunk.
A ``scan_layers`` model serves from one stacked pool, (L, P, page,
hkv*d) tensors that the decoder views flat, each layer offsetting the page
tables by ``layer * P``; the page ids the pool hands out are per layer, so
the trash page is page 0 of every layer.
``cache_dtype=torch.int8`` keeps the pool as int8 pages with f32 scale
pages (half the bytes of bf16 pages): decode then attends through B7 at
s_q = 1, verify windows through B7 and prefill windows through B8, and the
admission scatter moves the scale pages with the values.

What differs from the JAX engine: the model holds its weights (there is no
``params`` argument); ``jax.jit`` and ``lax.scan`` become eager calls and
Python loops; page writes and the admission scatter update the pool in
place; random sampling draws from one ``torch.Generator`` seeded from
``rng_seed`` (JAX folds the request id into a key), so sampled tokens
differ from JAX's while greedy ones agree.

Tensor-parallel serving (``mesh=``, ``engine.py:158-222``): every rank of
the mesh runs the same engine on the same requests; the model is cut to
the rank's heads, MLP columns and vocabulary rows by ``param_shardings``
(name -> placements, :func:`merlin_tpu_torch.core.partitioning.
sharding_for_tree`; the rules' when None) unless it was cut already, and
the pool holds the rank's head-packed lanes (a lane shard IS a head
shard), its int8 scale pages 128 / tp lanes in the whole pool's stride.
The paged kernels run on those local lanes; the logits are gathered, so
every rank picks the same tokens. The checks are JAX's: the heads must
divide the tensor axis, and an int8 pool needs kv_heads | 128.
:meth:`close` restores the global mesh the engine replaced.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import gc
import itertools
import threading
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from merlin_tpu_torch.core.mesh import (
    axis_size, get_global_mesh, set_global_mesh)
from merlin_tpu_torch.core.parallel import apply_tensor_parallel
from merlin_tpu_torch.generate.speculative import _scatter_rows
from merlin_tpu_torch.models.decoder import DecoderConfig, init_kv_cache
from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops.paged_attention import PagePool
from merlin_tpu_torch.utils.profiling import annotate

_TRASH = "__trash__"   # PagePool seq-id pinning physical page 0


def _multi_query_model(model: nn.Module) -> nn.Module:
    """The serving model with ``cfg.paged_multi_query=True``: a copy of the
    module tree that SHARES every parameter and buffer tensor with it
    (only the s_q > 1 paged branch changes: windows over arbitrary tables
    instead of identity-mapped prefill)."""
    shared = {id(t): t for t in itertools.chain(model.parameters(),
                                                 model.buffers())}
    for module in model.modules():       # process groups and the mesh too
        for key in ("tp_group", "parallel_info"):
            value = getattr(module, key, None)
            if value is not None:
                shared[id(value)] = value
    clone = copy.deepcopy(model, shared)
    for module in clone.modules():
        cfg = getattr(module, "cfg", None)
        if isinstance(cfg, DecoderConfig):
            module.cfg = dataclasses.replace(cfg, paged_multi_query=True)
        elif isinstance(getattr(cfg, "lm", None), DecoderConfig):
            module.cfg = dataclasses.replace(cfg, lm=dataclasses.replace(
                cfg.lm, paged_multi_query=True))
    return clone


def _capture(fn: Callable[[], None],
             device: torch.device) -> Optional[Callable[[], None]]:
    """``fn``'s work captured once as a CUDA graph on ``device``: its
    replay, or None on a device without graphs. The capture runs nothing;
    each replay runs the captured work and counts the kernel launches the
    capture counted. A host sync or a copy from the host inside ``fn``
    makes the capture raise."""
    if device.type != "cuda":
        return None
    graph = torch.cuda.CUDAGraph()
    with _build.recorded_launches() as launched, \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    _build.add_launches(launched, -1)     # recorded, not run

    def replay():
        graph.replay()
        _build.add_launches(launched)
    return replay


def _with(t: torch.Tensor, index, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[index] = value``: tensors already handed to
    queued work are never changed in place."""
    t = t.clone()
    t[index] = value
    return t


@dataclasses.dataclass
class Request:
    req_id: int
    input_ids: np.ndarray          # (prompt_len,)
    max_new_tokens: int = 128
    temperature: float = 0.0
    # streaming callback (token, done). A NEGATIVE token is the error
    # sentinel: the request failed (``error`` holds the message), done is
    # True, and the token must not be decoded as text.
    emit: Optional[Callable[[int, bool], None]] = None

    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    # tokens of `generated` already folded into input_ids by a previous
    # preemption (a twice-preempted request must not duplicate them)
    baked_generated: int = 0


class ServingEngine:
    """Fixed-slot continuous batching, driven by :meth:`step` (one thread)."""

    def __init__(self, model: nn.Module, *, num_slots: int = 4,
                 max_len: int = 2048, eos_id: int = 2, pad_id: int = 0,
                 prompt_bucket: int = 128, page_size: int = 128,
                 cache_dtype: torch.dtype = torch.bfloat16, rng_seed: int = 0,
                 chunk_steps: int = 8, pipeline: int = 1,
                 spec_draft: int = 0, spec_ngram: int = 2,
                 prefill_chunk: int = 0, prefill_windows_per_step: int = 4,
                 prefill_chunk_min: int = 0, mesh=None,
                 param_shardings=None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        # speculative windows: each step, every active slot proposes k
        # draft tokens from its own history (n-gram continuation) and one
        # (k+1)-token window scores them; the accepted prefix commits.
        # Rejected drafts need no rollback: `lengths` snap back and later
        # windows overwrite the dead page rows. Sampled slots ride along at
        # one token per window; chunk_steps then counts windows.
        self.spec_draft = int(spec_draft)
        self.spec_ngram = int(spec_ngram)
        # chunked prefill: prompts admit in (1, C) windows straight into the
        # slot's pool pages; keep C a multiple of page_size
        self.prefill_chunk = int(prefill_chunk)
        # per-STEP window budget (in units of C): bounds the decode stall
        # any one step pays to admissions while letting short prompts admit
        # in one step
        self.prefill_windows_per_step = max(int(prefill_windows_per_step),
                                            1)
        # hybrid admission: prompts of true length <= prefill_chunk_min take
        # the whole-prompt route even when chunking is on (0 = always chunk)
        self.prefill_chunk_min = int(prefill_chunk_min)
        # slot -> in-progress chunked-prefill state (slot occupied but not
        # yet decoding; windows advance oldest-first per step)
        self._prefilling = {}
        self.chunk_steps = max(int(chunk_steps), 1)
        # worst-case cache/token growth of one chunk
        self.tokens_per_chunk = self.chunk_steps * (
            (self.spec_draft + 1) if self.spec_draft else 1)
        # chunks whose tokens are read back `pipeline` chunks late: the
        # next chunk is queued on the card before the host waits for this
        # one. EOS detection lags by as much; a finishing request wastes at
        # most pipeline * chunk_steps decode tokens. A stale write to a
        # freed page is safe: a page re-allocated to another sequence has
        # every position overwritten before that sequence's length (the
        # read gate) passes it.
        self.pipeline = max(int(pipeline), 0)
        self._inflight: "collections.deque" = collections.deque()
        self.model = model
        self.num_slots = num_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.prompt_bucket = prompt_bucket
        self.page_size = page_size

        lm_cfg = model.cfg.lm if hasattr(model.cfg, "lm") else model.cfg
        self.lm_cfg = lm_cfg
        self._cache_dtype = cache_dtype
        # --- tensor-parallel serving over a device mesh ------------------
        self.mesh = mesh
        self._prev_mesh = None
        self.tp = axis_size(mesh, "tensor")
        if self.tp > 1:
            if cache_dtype == torch.int8 and 128 % lm_cfg.kv_heads:
                raise ValueError(
                    "tensor-sharded int8 pools need kv_heads | 128 (the "
                    "strided scale-lane layout must align to the shard)")
            if lm_cfg.num_heads % self.tp or lm_cfg.kv_heads % self.tp:
                raise ValueError(
                    f"heads ({lm_cfg.num_heads}/{lm_cfg.kv_heads}) must "
                    f"divide the tensor axis ({self.tp})")
            if getattr(model, "parallel_info", None) is None:
                apply_tensor_parallel(model, mesh, param_shardings)
        if mesh is not None:
            self._prev_mesh = get_global_mesh()
            set_global_mesh(mesh)
        self.cache = init_kv_cache(lm_cfg, num_slots, max_len=max_len,
                                   dtype=cache_dtype, layout="paged",
                                   page_size=page_size,
                                   tensor_parallel=self.tp,
                                   device=self.device)
        self.pages_per_slot = self.cache["page_tables"].shape[1]
        # a scanned decoder's pool is one dict of (L, P, ...) tensors whose
        # page ids are per layer (engine.py:188-192)
        layers = self.cache["layers"]
        self._stacked = isinstance(layers, dict)
        total_pages = (layers["k_pages"].shape[1] if self._stacked
                       else layers[0]["k_pages"].shape[0])
        self.pool = PagePool(total_pages, page_size, self.pages_per_slot)
        self.pool.allocate(_TRASH, 1)   # pins physical page 0
        self._pages_reserved = self.pool.free_pages
        # counters of stats(): requests taken into a slot (again after a
        # preemption), finished, failed, and preemptions
        self._admitted = self._finished = self._failed = self._preempted = 0
        # decode chunks replayed from the captured step, and issued eagerly
        self._graph_replays = self._eager_chunks = 0
        # the captured decode step's replay (None until the first chunk
        # that can replay) and the buffers it reads and updates in place
        self._graph: Optional[Callable[[], None]] = None
        self._static: Optional[Dict[str, torch.Tensor]] = None
        # set when the device cannot capture; tests set it to keep the
        # engine eager
        self._eager_only = False
        # host mirror of the device page tables; rows of zeros alias the
        # trash page (idle slots write there, never read)
        self._tables = np.zeros((num_slots, self.pages_per_slot), np.int32)
        self._tables_dirty = False
        self.cache["page_tables"] = self._upload(self._tables)

        self.slots: List[Optional[Request]] = [None] * num_slots
        self._queue: "collections.deque[Request]" = collections.deque()
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(rng_seed)
        self._next_id = 0
        self._lock = threading.Lock()
        self._slot_tokens = np.zeros(self.num_slots, np.int32)
        self._slot_len = np.zeros(self.num_slots, np.int64)
        # device-side mirrors, invalidated on admission
        self._tokens_dev = None
        self._active_np = None
        self._active_dev = None
        self._temps_dev = None

        self.multi_model = (_multi_query_model(model)
                            if (self.spec_draft or self.prefill_chunk)
                            else None)
        if self.spec_draft:
            # host mirror of per-slot token history (prompt + emitted);
            # device copies are rebuilt lazily after fail_all
            self._hist_np = np.zeros((num_slots, max_len), np.int32)
            self._hist_len_np = np.zeros(num_slots, np.int32)
            self._hist_dev = None
            self._hist_len_dev = None

    # ------------------------------------------------------------------
    # device pieces (the JAX engine's jitted functions)
    # ------------------------------------------------------------------
    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A device copy of a host array, made before this returns: the
        host mirrors are changed right after an upload."""
        return torch.tensor(array, device=self.device)

    def _pick(self, logits, temps, sample: bool):
        """Greedy token per row, or a sampled one where temps > 1e-4
        (``sample`` says whether any row samples: the host knows)."""
        out = torch.argmax(logits, dim=-1).to(torch.int32)
        if sample:
            probs = torch.softmax(
                logits.float() / temps.clamp_min(1e-4)[:, None], dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self._rng)[:, 0]
            out = torch.where(temps > 1e-4, drawn.to(torch.int32), out)
        return out

    def _first_token(self, logits, temperature: float):
        """The post-prefill token of one request, left on the device:
        admissions fetch their tokens in one transfer."""
        temps = torch.full((1,), temperature, device=self.device)
        return self._pick(logits[:1], temps, temperature > 1e-4)[0]

    def _prefill(self, ids, mask, small_cache):
        b, s = ids.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        logits, new_cache = self.model(
            ids, segment_ids=mask.to(torch.int32), positions=positions,
            kv_cache=small_cache)
        length = mask.sum(dim=1, dtype=torch.int32)
        next_logits = logits[torch.arange(b, device=self.device),
                             length.long() - 1]
        return next_logits, new_cache, length

    def _insert(self, small_layers, phys, slot, small_lengths):
        """Scatter one prefilled sequence's pages (and, for an int8 pool,
        its scale pages) into pool pages ``phys`` (arbitrary, not
        contiguous); each head-packed page is one row block. A stacked
        pool takes them along its pages axis 1, every layer at once
        (``engine.py:255-275``). In place."""
        if self._stacked:
            for key, big in self.cache["layers"].items():
                big[:, phys] = small_layers[key].to(big.dtype)
        else:
            for big, small in zip(self.cache["layers"], small_layers):
                for key in big:
                    big[key][phys] = small[key].to(big[key].dtype)
        self.cache["lengths"] = _with(self.cache["lengths"], slot,
                                      small_lengths[0])

    def _decode_one(self, tokens, active, temps, sample):
        lengths = self.cache["lengths"]
        logits, new_cache = self.model(
            tokens[:, None], positions=lengths[:, None], kv_cache=self.cache)
        out = self._pick(logits[:, 0], temps, sample)
        out = torch.where(active, out, self.pad_id)
        # inactive slots must not advance their lengths
        new_cache["lengths"] = torch.where(active, new_cache["lengths"],
                                           lengths)
        self.cache = new_cache
        return out

    def _decode_chunk(self, tokens, active, temps, sample):
        """`chunk_steps` decode steps; returns ((slots, chunk_steps) tokens,
        the last step's tokens)."""
        outs = []
        for _ in range(self.chunk_steps):
            tokens = self._decode_one(tokens, active, temps, sample)
            outs.append(tokens)
        return torch.stack(outs, dim=1), tokens

    def _static_inputs(self) -> Dict[str, torch.Tensor]:
        """The graph's buffers, holding the engine's current tokens, active
        mask, lengths and tables: each engine tensor that is not already
        the buffer (an admission, a table upload or ``fail_all`` made a new
        one) is copied in on the stream. The engine's names then point at
        the buffers, which each step updates in place."""
        s = self._static
        sources = {"tokens": self._tokens_dev, "active": self._active_dev,
                   "lengths": self.cache["lengths"],
                   "tables": self.cache["page_tables"]}
        if s is None:
            s = self._static = {k: t.clone() for k, t in sources.items()}
        else:
            for key, src in sources.items():
                if src is not s[key]:
                    s[key].copy_(src)
        self._tokens_dev, self._active_dev = s["tokens"], s["active"]
        self.cache["lengths"] = s["lengths"]
        self.cache["page_tables"] = s["tables"]
        return s

    def _static_step(self):
        """One greedy decode step over the graph's buffers, updating tokens
        and lengths in place: the step the graph holds, and its eager run
        before the capture."""
        s = self._static
        out = self._decode_one(s["tokens"], s["active"], None, False)
        s["lengths"].copy_(self.cache["lengths"])
        s["tokens"].copy_(out)
        self.cache["lengths"] = s["lengths"]

    def _replay_chunk(self):
        """`chunk_steps` greedy decode steps as replays of the captured
        step, as :meth:`_decode_chunk` returns them; the engine's first such
        chunk runs the step eagerly on the same buffers, then captures it.
        Each step's tokens are copied out of the buffers, which later
        steps overwrite before the chunk is read back. Where the device
        cannot capture, the engine stays eager from then on. Returns the
        chunk, the last step's tokens and whether the chunk replayed."""
        s = self._static_inputs()
        chunk = torch.empty((self.num_slots, self.chunk_steps),
                            dtype=torch.int32, device=self.device)
        first = self._graph is None
        for i in range(self.chunk_steps):
            if first:
                self._static_step()
            else:
                with annotate("merlin.decoder.layers"), \
                        annotate("merlin.engine.graph_replay"):
                    self._graph()
            chunk[:, i] = s["tokens"]
        if first:
            # the kernels are built, cuBLAS loaded and the paged kernels'
            # counters allocated by the eager run
            self._graph = _capture(self._static_step, self.device)
            self._eager_only = self._graph is None
        return chunk, s["tokens"], not first

    def _prefill_window(self, ids, tables_row, start: int, row: int,
                        temperature: float):
        """One (1, C) prompt window straight into pool pages: it appends
        at start..start+C-1 and attends causally over the slot's whole
        paged history. ``row``: window row of the prompt's LAST real token
        (only the final window's first token is used; padded rows write
        garbage K/V at positions >= plen, which decode overwrites before
        they are ever attended)."""
        C = self.prefill_chunk
        cache = {"layers": self.cache["layers"], "page_tables": tables_row,
                 "lengths": torch.full((1,), start, dtype=torch.int32,
                                       device=self.device),
                 "index": 0}
        positions = torch.arange(start, start + C, device=self.device)[None]
        logits, _ = self.multi_model(ids, positions=positions,
                                     kv_cache=cache)
        return self._first_token(logits[:, row], temperature)

    def _propose(self, hist, cur):
        """Latest-occurrence n-gram continuation from each slot's history:
        (b, k) draft tokens (the last token repeated where none matches)."""
        k, ngram = self.spec_draft, self.spec_ngram
        b, L = hist.shape
        dev = hist.device
        cur = cur.long()
        tail = torch.gather(hist, 1, (cur[:, None] - ngram + torch.arange(
            ngram, device=dev)[None]).clamp_min(0))
        npos = L - ngram + 1
        match = torch.ones((b, npos), dtype=torch.bool, device=dev)
        for t in range(ngram):
            match &= hist[:, t:t + npos] == tail[:, t:t + 1]
        pos = torch.arange(npos, device=dev)[None]
        match &= pos + ngram <= (cur - 1)[:, None]
        best = torch.where(match, pos, -1).amax(dim=1)
        has = best >= 0
        start = torch.where(has, best + ngram, 0)
        draft = torch.gather(hist, 1, (start[:, None] + torch.arange(
            k, device=dev)[None]).clamp(0, L - 1))
        last = torch.gather(hist, 1, (cur[:, None] - 1).clamp_min(0))
        return torch.where(has[:, None], draft, last)

    def _spec_window(self, toks, active, temps, sample):
        k = self.spec_draft
        lengths = self.cache["lengths"]
        draft = self._propose(self._hist_dev, self._hist_len_dev)
        ids = torch.cat([toks[:, None], draft], dim=1)
        positions = lengths[:, None] + torch.arange(k + 1,
                                                    device=self.device)[None]
        logits, new_cache = self.multi_model(ids, positions=positions,
                                             kv_cache=self.cache)
        g = torch.argmax(logits, dim=-1).to(torch.int32)
        cand = g.clone()
        cand[:, 0] = self._pick(logits[:, 0], temps, sample)
        greedy_row = temps <= 1e-4
        ok = torch.cumprod((g[:, :k] == draft).to(torch.int32), dim=1)
        count = torch.where(greedy_row, ok.sum(dim=1) + 1, 1)
        count = torch.where(active, count, 0).to(torch.int32)
        emit_mask = torch.arange(k + 1, device=self.device)[None] \
            < count[:, None]
        emitted = torch.where(emit_mask, cand, -1)   # -1 = hole
        new_cache["lengths"] = torch.where(active, lengths + count, lengths)
        self.cache = new_cache
        self._hist_dev = _scatter_rows(self._hist_dev, self._hist_len_dev,
                                       cand, emit_mask)
        self._hist_len_dev = self._hist_len_dev + count
        nxt = torch.gather(cand, 1, (count.long() - 1).clamp_min(0)[:, None])
        return torch.where(active, nxt[:, 0], toks), emitted

    def _spec_chunk(self, tokens, active, temps, sample):
        """`chunk_steps` verify windows; returns ((slots, windows * (k+1))
        tokens with -1 holes, in order; the last window's next tokens)."""
        ems = []
        for _ in range(self.chunk_steps):
            tokens, emitted = self._spec_window(tokens, active, temps,
                                                sample)
            ems.append(emitted)
        return torch.cat(ems, dim=1), tokens

    # ------------------------------------------------------------------
    def submit(self, input_ids, *, max_new_tokens: int = 128,
               temperature: float = 0.0,
               emit: Optional[Callable] = None) -> Request:
        with self._lock:
            req = Request(self._next_id, np.asarray(input_ids, np.int32),
                          max_new_tokens=max_new_tokens,
                          temperature=temperature, emit=emit)
            self._next_id += 1
            with annotate("merlin.engine.submit", req.req_id):
                self._queue.append(req)
        return req

    def stats(self) -> Dict[str, int]:
        """The engine's counters, safe to read from any thread: requests
        queued, decoding (``active``) and in chunked prefill; requests
        taken into a slot (``admitted``; a preempted one counts again when
        it re-admits), finished, failed, and preemptions since start; the
        pool's pages held by requests and those requests may hold; decode
        chunks replayed from the captured step (``graph_replays``) and
        issued eagerly (``eager_chunks``)."""
        with self._lock:
            queued = len(self._queue)
        prefilling = len(self._prefilling)
        occupied = sum(r is not None for r in self.slots)
        return {"queued": queued, "active": occupied - prefilling,
                "prefilling": prefilling, "admitted": self._admitted,
                "finished": self._finished, "failed": self._failed,
                "preempted": self._preempted,
                "pages_used": self._pages_reserved - self.pool.free_pages,
                "pages_reserved": self._pages_reserved,
                "graph_replays": self._graph_replays,
                "eager_chunks": self._eager_chunks}

    def _route_chunked(self, ids: np.ndarray) -> bool:
        """Hybrid admission policy: chunk only prompts strictly longer
        than ``prefill_chunk_min`` (0 = chunk everything)."""
        return bool(self.prefill_chunk) and \
            len(ids) > self.prefill_chunk_min

    def _bucketed(self, ids: np.ndarray, chunked: bool) -> np.ndarray:
        # chunked prefill pads to the window size instead
        bucket = self.prefill_chunk if chunked else self.prompt_bucket
        pad = (-len(ids)) % bucket or 0
        if pad:
            ids = np.concatenate([ids, np.full(pad, self.pad_id, np.int32)])
        return ids[None]

    def _pop_request(self) -> Optional[Request]:
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def _requeue_front(self, req: Request):
        with self._lock:
            self._queue.appendleft(req)

    def _admit(self):
        staged = []   # (slot, req, plen, device first-token scalar)
        for slot in range(self.num_slots):
            if self.slots[slot] is not None:
                continue
            while True:
                req = self._pop_request()
                if req is None:
                    self._resolve_admissions(staged)
                    return
                chunked = self._route_chunked(req.input_ids)
                ids = self._bucketed(req.input_ids, chunked)
                try:
                    # reserve the bucketed prompt's pages (prefill writes
                    # the whole bucket; padded rows are masked by `lengths`)
                    table = self.pool.allocate(req.req_id, ids.shape[1])
                    break
                except MemoryError:
                    self._requeue_front(req)
                    self._resolve_admissions(staged)
                    return
                except ValueError as e:
                    # prompt longer than a slot can ever hold: fail just
                    # this request and retry the slot with the next one
                    req.done = True
                    req.error = str(e)
                    self._failed += 1
                    if req.emit:
                        req.emit(-1, True)  # error sentinel (see Request)
            plen = min(len(req.input_ids), ids.shape[1])
            self._admitted += 1
            if chunked:
                # the GLOBAL tables row stays on the trash page until the
                # prompt is fully written: concurrent decode chunks still
                # write a (masked-out) token for this slot at its stale
                # length, and that write must land in trash, not in the
                # pages the windows are filling. The windows use their own
                # private tables row.
                row = np.zeros(self.pages_per_slot, np.int32)
                row[:len(table)] = table
                self.slots[slot] = req
                self._prefilling[slot] = {
                    "req": req, "ids": ids, "plen": plen, "done": 0,
                    "n": ids.shape[1] // self.prefill_chunk,
                    "row": row, "tables_row": self._upload(row[None]),
                    "temp": float(req.temperature),
                }
                self._active_np = None
                continue
            with annotate("merlin.engine.prefill", req.req_id):
                mask = self._upload(np.arange(ids.shape[1])[None] < plen)
                small = init_kv_cache(
                    self.lm_cfg, 1, max_len=ids.shape[1], layout="paged",
                    page_size=self.page_size, dtype=self._cache_dtype,
                    tensor_parallel=self.tp, device=self.device)
                next_logits, small, length = self._prefill(
                    self._upload(ids), mask, small)
                tok_dev = self._first_token(next_logits, req.temperature)
            with annotate("merlin.engine.insert", req.req_id):
                self._insert(small["layers"],
                             self._upload(np.asarray(table, np.int64)), slot,
                             length)
                self._tables[slot] = 0
                self._tables[slot, :len(table)] = table
                self._tables_dirty = True
                self.slots[slot] = req
                self._finish_admission(slot, req, plen, tok_dev, staged)
        self._resolve_admissions(staged)

    def _finish_admission(self, slot, req, plen, tok_dev, staged):
        """Device-side bookkeeping once a slot's prefill produced its
        first token; the host fetch happens in _resolve_admissions."""
        self._slot_len[slot] = plen
        # the host copy of the tokens lags the latest queued chunk under
        # pipelining: update the device mirror, never rebuild it from host
        if self._tokens_dev is None:
            self._tokens_dev = self._upload(self._slot_tokens)
        self._tokens_dev = _with(self._tokens_dev, slot, tok_dev)
        if self.spec_draft and self._hist_dev is not None:
            row = np.zeros(self.max_len, np.int32)
            row[:plen] = req.input_ids[:plen]
            hist = _with(self._hist_dev, slot, self._upload(row))
            hist[slot, plen] = tok_dev
            self._hist_dev = hist
            self._hist_len_dev = _with(self._hist_len_dev, slot, plen + 1)
        self._active_np = None
        staged.append((slot, req, plen, tok_dev))

    def _one_window(self, slot, staged):
        """Advance one (1, C) prefill window for `slot`; finish the
        admission when it was the last window."""
        st = self._prefilling[slot]
        ci, C = st["done"], self.prefill_chunk
        last_row = (st["plen"] - 1) - (st["n"] - 1) * C
        req_id = st["req"].req_id
        with annotate("merlin.engine.window", req_id):
            tok_dev = self._prefill_window(
                self._upload(st["ids"][:, ci * C:(ci + 1) * C]),
                st["tables_row"], ci * C,
                last_row if ci == st["n"] - 1 else 0, st["temp"])
        st["done"] = ci + 1
        if st["done"] == st["n"]:
            # ragged tail: snap the slot's length to the REAL prompt end
            # (garbage rows past plen are never attended; decode
            # overwrites them in order), and only now reveal the real
            # tables row globally
            with annotate("merlin.engine.insert", req_id):
                self.cache["lengths"] = _with(self.cache["lengths"], slot,
                                              st["plen"])
                self._tables[slot] = st["row"]
                self._tables_dirty = True
                del self._prefilling[slot]
                self._finish_admission(slot, st["req"], st["plen"], tok_dev,
                                       staged)

    def _advance_prefill(self):
        """Run up to `prefill_windows_per_step` pending prefill windows,
        OLDEST admission first (finishing one prompt beats spreading
        windows breadth-first: same work, earlier first tokens). With no
        active decode slot there is nothing to interleave with, so loop
        until at least one admission completes."""
        if not self._prefilling:
            return
        staged = []
        budget = self.prefill_windows_per_step
        while True:
            used = 0
            for slot in list(self._prefilling):   # insertion = admission order
                while slot in self._prefilling and used < budget:
                    self._one_window(slot, staged)
                    used += 1
                if used >= budget:
                    break
            active = any(r is not None and s not in self._prefilling
                         for s, r in enumerate(self.slots))
            if active or not self._prefilling:
                break
        self._resolve_admissions(staged)

    def _resolve_admissions(self, staged):
        """Fetch every staged first token in ONE device transfer and run
        the host bookkeeping (token history, emit callbacks, EOS)."""
        if not staged:
            return
        with annotate("merlin.engine.first_token"):
            toks = torch.stack([t for _, _, _, t in staged]).cpu().numpy()
        for (slot, req, plen, _), tok in zip(staged, toks):
            tok = int(tok)
            self._slot_tokens[slot] = tok
            if self.spec_draft:
                row = np.zeros(self.max_len, np.int32)
                row[:plen] = req.input_ids[:plen]
                row[plen] = tok
                self._hist_np[slot] = row
                self._hist_len_np[slot] = plen + 1
            self._record(slot, tok)

    def _record(self, slot: int, token: int):
        req = self.slots[slot]
        req.generated.append(int(token))
        self._slot_len[slot] += 1
        # safety margin: the cache may run ahead of the recorded tokens
        # by up to (1 + pipeline) chunks before the slot frees
        margin = self.tokens_per_chunk * (1 + self.pipeline) + 1
        done = (token == self.eos_id
                or len(req.generated) >= req.max_new_tokens
                or self._slot_len[slot] + margin >= self.max_len)
        if req.emit:
            req.emit(int(token), done)
        if done:
            req.done = True
            self._finished += 1
            self.slots[slot] = None
            self.pool.release(req.req_id)
            self._tables[slot] = 0
            self._tables_dirty = True

    # ------------------------------------------------------------------
    def _preempt_youngest(self, exclude: int) -> bool:
        """Release the most recently admitted other request back to the
        queue (vLLM recompute preemption: its prompt+generated tokens
        re-prefill on next admission). Returns False if no victim."""
        victims = [(req.req_id, slot) for slot, req in enumerate(self.slots)
                   if req is not None and slot != exclude]
        if not victims:
            return False
        _, slot = max(victims)
        req = self.slots[slot]
        self._preempted += 1
        self.pool.release(req.req_id)
        self.slots[slot] = None
        self._tables[slot] = 0
        self._tables_dirty = True
        # a mid-prefill victim just drops its progress; re-admission
        # rewrites every page from the (unchanged) prompt
        self._prefilling.pop(slot, None)
        fresh = req.generated[req.baked_generated:]
        req.input_ids = np.concatenate(
            [req.input_ids, np.asarray(fresh, np.int32)])
        req.baked_generated = len(req.generated)
        self._requeue_front(req)
        return True

    def _grow_pages(self):
        """Before each chunk, make sure every active slot owns pages for
        the tokens the chunk will write; upload the tables only when a row
        changed."""
        for slot, req in enumerate(self.slots):
            if req is None or slot in self._prefilling:
                continue  # prefilling slots pre-allocated their prompt
            need = min(int(self._slot_len[slot])
                       + self.tokens_per_chunk * (1 + self.pipeline) + 1,
                       self.pages_per_slot * self.page_size)
            drained = False
            while True:
                try:
                    table = self.pool.allocate(req.req_id, need)
                    break
                except MemoryError:
                    if not drained:
                        # settle all in-flight chunks first: finished
                        # requests release pages, and preempting with a
                        # chunk in flight would fork a victim's history
                        self._drain(force=True)
                        drained = True
                        if self.slots[slot] is not req:
                            break  # this very request just finished
                        continue
                    if not self._preempt_youngest(exclude=slot):
                        raise MemoryError(
                            "page pool exhausted by a single sequence")
            if self.slots[slot] is not req:
                continue
            new_row = np.zeros(self.pages_per_slot, np.int32)
            new_row[:len(table)] = table
            if not np.array_equal(new_row, self._tables[slot]):
                self._tables[slot] = new_row
                self._tables_dirty = True
        if self._tables_dirty:
            self.cache["page_tables"] = self._upload(self._tables)
            self._tables_dirty = False

    # ------------------------------------------------------------------
    def _drain(self, force: bool = False):
        """Read back and record in-flight chunks beyond the pipeline depth
        (all of them when ``force``), in ONE transfer. Each chunk is
        recorded against the REQUESTS captured when it was queued: a slot
        freed and re-admitted meanwhile must not get stale tokens.
        Otherwise wait until the card has finished all but the newest
        chunk: once replays let the host run ahead of the card, the next
        step's admissions then queue behind one chunk, not ``pipeline`` of
        them, while tokens are still read back ``pipeline`` chunks late."""
        if not force and len(self._inflight) <= self.pipeline:
            done = self._inflight[-2][2] if len(self._inflight) > 1 else None
            if done is not None:
                with annotate("merlin.engine.drain"), \
                        annotate("merlin.engine.readback"):
                    done.synchronize()
            return
        keep = 0 if (force or self.pipeline == 0) else 1
        batch = []
        while len(self._inflight) > keep:
            batch.append(self._inflight.popleft())
        if not batch:
            return
        with annotate("merlin.engine.drain"):
            with annotate("merlin.engine.readback"):
                stacked = torch.stack(
                    [dev for dev, _, _ in batch]).cpu().numpy()
            for chunk, (_, reqs, _) in zip(stacked, batch):
                for slot in range(self.num_slots):
                    if reqs[slot] is None \
                            or self.slots[slot] is not reqs[slot]:
                        continue
                    for tok in chunk[slot]:
                        if tok < 0:
                            continue  # speculative window hole (not emitted)
                        self._record(slot, tok)
                        if self.slots[slot] is None:
                            break  # finished mid-chunk; rest is void

    @torch.no_grad()
    def step(self) -> int:
        """Admit waiting requests, decode `chunk_steps` tokens for all
        active slots, and record results `pipeline` chunks behind.
        Returns the number of active slots processed."""
        with annotate("merlin.engine.step"):
            return self._step()

    def _step(self) -> int:
        with annotate("merlin.engine.admit"):
            self._admit()
            self._advance_prefill()
        if not any(r is not None for r in self.slots):
            self._drain(force=True)
            return 0
        # grow BEFORE taking the active mask: growth may preempt a slot,
        # and a preempted slot must not be decoded or recorded this chunk
        with annotate("merlin.engine.grow_pages"):
            self._grow_pages()
        with annotate("merlin.engine.decode"):
            active_mask = self._issue_chunk()
        if active_mask is None:
            return 0
        self._drain()
        return int(active_mask.sum())

    def _issue_chunk(self) -> Optional[np.ndarray]:
        """Queue one chunk for the active slots on the device; their mask,
        or None when every occupied slot is still in chunked prefill."""
        active_mask = np.asarray(
            [r is not None and s not in self._prefilling
             for s, r in enumerate(self.slots)], bool)
        if not active_mask.any():
            return None
        temps = np.asarray(
            [r.temperature if r else 0.0 for r in self.slots], np.float32)
        # upload tokens/active/temps only when they changed, and feed the
        # previous chunk's device tokens straight back between quiet steps
        if self._tokens_dev is None:
            self._tokens_dev = self._upload(self._slot_tokens)
        if self._active_np is None or \
                not np.array_equal(active_mask, self._active_np):
            self._active_np = active_mask
            self._active_dev = self._upload(active_mask)
            self._temps_dev = self._upload(temps)
        sample = float(temps.max()) > 1e-4
        replayed = False
        if self.spec_draft:
            if self._hist_dev is None:
                self._hist_dev = self._upload(self._hist_np)
                self._hist_len_dev = self._upload(self._hist_len_np)
            chunk_dev, last = self._spec_chunk(
                self._tokens_dev, self._active_dev, self._temps_dev, sample)
        elif sample or self.tp > 1 or self._eager_only:
            # a sampled row draws from the generator, and a tensor group's
            # collectives are not captured
            chunk_dev, last = self._decode_chunk(
                self._tokens_dev, self._active_dev, self._temps_dev, sample)
        else:
            chunk_dev, last, replayed = self._replay_chunk()
        if replayed:
            self._graph_replays += 1
        else:
            self._eager_chunks += 1
            # an empty span marks the step's decode issue as eager
            with annotate("merlin.engine.eager_chunk"):
                pass
        self._tokens_dev = last
        # the event completes once the card has finished this chunk
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        # a prefilling slot is occupied but NOT in this chunk: its rows
        # are pad and must never be recorded against the new occupant
        self._inflight.append((chunk_dev, [
            None if s in self._prefilling else r
            for s, r in enumerate(self.slots)], done))
        return active_mask

    def fail_all(self, reason: str):
        """Fail every active and queued request (error set, error sentinel
        emitted) and reset the slots/pool/pipeline to a clean state: the
        recovery path for an exception out of step(). Afterwards the
        engine accepts new requests."""
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for req in [r for r in self.slots if r is not None] + pending:
            req.done = True
            req.error = reason
            self._failed += 1
            if req.emit:
                try:
                    req.emit(-1, True)  # error sentinel (see Request)
                except Exception:
                    pass  # a failing client must not stop the reset
        for slot, req in enumerate(self.slots):
            if req is not None:
                self.pool.release(req.req_id)
                self.slots[slot] = None
        self._inflight.clear()
        self._prefilling.clear()
        self._tables[:] = 0
        self._tables_dirty = True
        self._slot_tokens[:] = 0
        self._slot_len[:] = 0
        self._tokens_dev = None
        self._active_np = None
        if self.spec_draft:
            self._hist_np[:] = 0
            self._hist_len_np[:] = 0
            self._hist_dev = None
            self._hist_len_dev = None

    def close(self):
        """Drop the engine's device buffers (the KV pool, the device
        mirrors) and its references to the model, so that the next
        engine's pool fits beside the weights, and restore the global mesh
        the engine replaced (when it is still the engine's). Idempotent."""
        if self.mesh is not None and get_global_mesh() is self.mesh:
            set_global_mesh(self._prev_mesh)
        self.cache = None
        self.model = self.multi_model = None
        # the graph's private memory pool goes with it
        self._graph = self._static = None
        self._prefilling.clear()
        self._inflight.clear()
        self._tokens_dev = self._active_dev = self._temps_dev = None
        if self.spec_draft:
            self._hist_dev = self._hist_len_dev = None
        gc.collect()

    def run_until_idle(self, max_steps: int = 100000):
        while True:
            with self._lock:
                queued = bool(self._queue)
            if not queued and all(r is None for r in self.slots) \
                    and not self._inflight:
                return
            self.step()
            max_steps -= 1
            if max_steps <= 0:
                raise RuntimeError("engine did not drain")
