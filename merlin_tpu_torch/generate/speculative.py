"""Prompt-lookup speculative decoding, greedy-exact, with no draft model
(counterpart of ``merlin_tpu/generate/speculative.py``).

Each window runs ``draft_len + 1`` tokens: the last committed token, then
a draft of k tokens continued from the latest earlier occurrence of the
sequence's last n-gram in its own history (prompt and generated). The
greedy targets g_j = argmax(logits_j) give the outcome directly: the
emitted tokens are g_0..g_m, where m is the length of the accepted draft
prefix (d_{j+1} == g_j), so each window advances m + 1 >= 1 tokens. The
tokens are those of the plain greedy ``Generator``; acceptance changes only
how many forwards they take.

The dense cache is slot-sparse: every window claims k + 1 fresh slots for
every row at one shared write cursor, and the slots of rejected drafts are
invalidated afterwards by writing 0 into their validity ids (``seg``),
which the decoder's segment masking then hides; positions are the true
per-row ones. So the cache holds the prompt plus ``max_new_tokens``
windows of k + 1 slots.

Needs RoPE or learned positions (ALiBi's bias would read the skewed slot
distance), the dense cache, and greedy decoding. What differs from the JAX
module: the model holds its weights, the ``lax.while_loop`` is a Python
loop over eager calls, the seg write is in place, and the JAX asserts are
``ValueError``s.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
from torch import nn

from merlin_tpu_torch.generate.decode import GenerateConfig
from merlin_tpu_torch.models.decoder import init_kv_cache


def _scatter_rows(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """buf[i, start[i] + j] = vals[i, j] where mask[i, j]; writes past the
    end of a row are dropped. Returns a new tensor (buf is not changed)."""
    b, w = vals.shape
    cols = start.long()[:, None] + torch.arange(w, device=buf.device)[None]
    keep = mask & (cols < buf.shape[1])
    # dropped writes land in a spare column, cut off below
    cols = torch.where(keep, cols, buf.shape[1])
    out = torch.cat([buf, buf.new_zeros((b, 1))], dim=1)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, w)
    out[rows, cols] = vals.to(buf.dtype)
    return out[:, :-1].contiguous()


def _take(buf: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(buf, cols, axis=1)``: negative columns count
    from the end."""
    cols = cols.long()
    return torch.gather(buf, 1, torch.where(cols < 0, cols + buf.shape[1],
                                            cols))


class SpeculativeGenerator:
    """Greedy batch generation through prompt-lookup speculative windows.

    Gives the tokens of ``Generator`` with ``do_sample=False``; a call
    returns (tokens, n_windows, tokens generated per row), so callers can
    report the tokens per forward."""

    def __init__(self, model: nn.Module, gen_cfg: GenerateConfig, *,
                 draft_len: int = 4, ngram: int = 2,
                 device: Union[str, torch.device] = "cuda"):
        if gen_cfg.do_sample:
            raise ValueError("speculative decoding is greedy only")
        if gen_cfg.kv_layout != "dense":
            raise ValueError("speculative decoding needs the dense cache")
        lm_cfg = model.cfg.lm if hasattr(model.cfg, "lm") else model.cfg
        if lm_cfg.positional == "alibi":
            raise ValueError("the slot-sparse speculative cache skews "
                             "ALiBi's slot-distance bias")
        if draft_len < 1 or ngram < 1:
            raise ValueError("draft_len and ngram must be >= 1")
        self.model = model
        self.cfg = gen_cfg
        self.k = int(draft_len)
        self.ngram = int(ngram)
        self.device = torch.device(device)

    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t.to(self.device, dtype) if dtype else t.to(self.device)

    def _propose(self, buf: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
        """The continuation (b, k) of the latest earlier occurrence of each
        row's last n-gram in ``buf`` (b, L), whose first ``cur`` tokens are
        written; the last token repeated where there is none (cheap, and
        simply rejected)."""
        n, k = self.ngram, self.k
        b, L = buf.shape
        dev = buf.device
        tail = _take(buf, cur[:, None] - n + torch.arange(n, device=dev)[None])
        npos = L - n + 1
        match = torch.ones((b, npos), dtype=torch.bool, device=dev)
        for t in range(n):
            match &= buf[:, t:t + npos] == tail[:, t:t + 1]
        pos = torch.arange(npos, device=dev)[None]
        # the continuation must start inside the written history and not
        # be the tail's own occurrence
        match &= pos + n <= (cur - 1)[:, None]
        best = torch.where(match, pos, -1).amax(dim=1)
        has = best >= 0
        start = torch.where(has, best + n, 0)
        draft = _take(buf, (start[:, None] + torch.arange(k, device=dev)[None]
                            ).clamp(0, L - 1))
        last = _take(buf, cur[:, None] - 1)
        return torch.where(has[:, None], draft, last)

    def _window(self, prev_tok, draft, cur, done, cache):
        """One (k+1)-token verify forward. ``cur`` (b,) counts the committed
        tokens; ``prev_tok``, the last of them, has no K/V in the cache yet
        and leads the window at position cur - 1. Returns the greedy
        targets (b, k+1), the accepted draft lengths (b,) and the cache with
        the rejected slots invalidated."""
        k = self.k
        dev = self.device
        ids = torch.cat([prev_tok[:, None], draft], dim=1)
        positions = (cur - 1)[:, None] + torch.arange(k + 1, device=dev)[None]
        seg = (~done[:, None]).to(torch.int32).expand(-1, k + 1)
        idx = cache["index"]
        logits, cache = self.model(ids.long(), positions=positions,
                                   segment_ids=seg, kv_cache=cache)
        g = torch.argmax(logits, dim=-1).to(torch.int32)       # (b, k+1)
        ok = torch.cumprod((g[:, :k] == draft).to(torch.int32), dim=1)
        m = ok.sum(dim=1)
        # window slot j (0 = prev token) stays valid iff j <= m; done rows
        # wrote seg 0 already
        keep = ((torch.arange(k + 1, device=dev)[None] <= m[:, None])
                & ~done[:, None])
        cache["seg"][:, idx:idx + k + 1] = keep.to(torch.int32)
        return g, m, cache

    @torch.no_grad()
    def __call__(self, input_ids, *, images=None, attention_mask=None
                 ) -> Tuple[np.ndarray, int, np.ndarray]:
        """Returns (tokens (b, max_new_tokens) int32, pad after a stop
        token, which is included; the number of windows run; the tokens
        generated per row (b,) int32)."""
        cfg = self.cfg
        k, T = self.k, cfg.max_new_tokens
        dev = self.device
        ids = self._as_tensor(input_ids, torch.int64)
        mask = (ids != cfg.pad_id) if attention_mask is None else \
            self._as_tensor(attention_mask, torch.bool)
        bucket = cfg.prompt_bucket
        if bucket and ids.shape[1] % bucket:
            pad = bucket - ids.shape[1] % bucket
            ids = torch.nn.functional.pad(ids, (0, pad), value=cfg.pad_id)
            mask = torch.nn.functional.pad(mask, (0, pad), value=False)
        b, s = ids.shape
        lm_cfg = self.model.cfg.lm if hasattr(self.model.cfg, "lm") \
            else self.model.cfg
        # slot-sparse: every window claims k+1 slots even when one token
        # lands, so capacity is prompt + T windows * (k+1)
        cache = init_kv_cache(lm_cfg, b, s + 1 + T * (k + 1),
                              dtype=cfg.cache_dtype, device=dev)
        kwargs = {"images": self._as_tensor(images)} \
            if images is not None else {}
        positions = torch.arange(s, device=dev).expand(b, s)
        logits, cache = self.model(
            ids, segment_ids=mask.to(torch.int32), positions=positions,
            kv_cache=cache, **kwargs)
        lengths = mask.sum(dim=1)
        first = logits[torch.arange(b, device=dev), lengths - 1]
        # token history for the n-gram lookup: prompt + generated
        buf = torch.nn.functional.pad(ids, (0, T + 1), value=cfg.pad_id)

        stop_ids = torch.tensor((cfg.eos_id,) + tuple(cfg.stop_token_ids),
                                device=dev)
        out = torch.full((b, T), cfg.pad_id, dtype=torch.int32, device=dev)
        prev = torch.argmax(first, dim=-1).to(torch.int32)
        done = torch.isin(prev, stop_ids)
        out[:, 0] = prev
        buf = _scatter_rows(buf, lengths, prev[:, None],
                            torch.ones((b, 1), dtype=torch.bool, device=dev))
        gen = torch.ones(b, dtype=torch.int64, device=dev)
        upto = torch.arange(k + 1, device=dev)[None]
        windows = 0
        # the host reads `done` once a window, as the while_loop's
        # condition does on the device
        while windows < T and not bool(done.all()):
            draft = self._propose(buf, lengths + gen)
            g, m, cache = self._window(prev, draft, lengths + gen, done,
                                       cache)
            # emitted tokens g_0..g_m, cut at the first stop id and at the
            # remaining budget
            is_stop = torch.isin(g, stop_ids)
            stop_at = torch.where(is_stop, upto, k + 1).amin(dim=1)
            count = torch.minimum(m + 1, stop_at + 1)
            count = torch.minimum(count, T - gen)
            count = torch.where(done, 0, count)
            emit = upto < count[:, None]
            out = _scatter_rows(out, gen, g, emit)
            buf = _scatter_rows(buf, lengths + gen, g, emit)
            hit_stop = (is_stop & emit).any(dim=1)
            gen = gen + count
            done = done | hit_stop | (gen >= T)
            prev = torch.where(done, prev, torch.gather(
                g, 1, (count - 1).clamp_min(0)[:, None])[:, 0])
            windows += 1
        return (out.cpu().numpy(), windows,
                gen.to(torch.int32).cpu().numpy())
