"""Beam search over a dense KV cache (counterpart of
``merlin_tpu/generate/beam.py``), with HF ``generate``'s beam semantics:

  * each step ranks max(2, 2 + n_stop) * k candidates over (beams * vocab),
    so stop tokens can never starve the beam refill;
  * a stop candidate among the top k ranks is banked as a finished
    hypothesis, its raw score divided by the generated length (counting the
    stop token) raised to ``length_penalty``, and its beam slot is refilled
    from the next best continuation;
  * a batch row is done once k hypotheses are banked and the best running
    beam, scored at the current length, cannot beat the worst banked one;
  * at the token budget, running beams join the pool normalized by the
    final length, and the best hypothesis wins.

What differs from the JAX module: the model holds its weights; the
``lax.while_loop`` is a Python loop over eager calls that skips the step
forward whose logits no later step reads; ``jax.lax.top_k`` puts the lower
index first among equal values, which ``torch.topk`` does not promise, so
every ranking here is a stable descending sort. The port's dense cache is
written in place by the forward, so the beam reorder builds new buffers
(:func:`_gather_beams`) instead of indexing into the ones being written.
The prompt is not bucketed, as in JAX.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
from torch import nn

from merlin_tpu_torch.generate.decode import GenerateConfig
from merlin_tpu_torch.models.decoder import init_kv_cache

NEG_INF = -1.0e7


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values."""
    values, index = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], index[..., :k]


def _gather_beams(cache, beam_idx: torch.Tensor, batch: int, beams: int):
    """A dense cache whose (batch * beams) rows are reordered by
    ``beam_idx`` (batch, beams): row (i, j) takes row (i, beam_idx[i, j]).
    Every layer's ``k``/``v`` and the ``seg``/``pos`` bookkeeping become new
    tensors; ``index`` (a Python int) is shared by all rows and stays."""
    rows = (torch.arange(batch, device=beam_idx.device)[:, None] * beams
            + beam_idx).reshape(-1)
    return {
        "layers": tuple({name: t.index_select(0, rows)
                         for name, t in layer.items()}
                        for layer in cache["layers"]),
        "seg": cache["seg"].index_select(0, rows),
        "pos": cache["pos"].index_select(0, rows),
        "index": cache["index"],
    }


class BeamSearch:
    """Beam search for a ``CausalLM`` or ``MMGPT``; ``gen_cfg.num_beams``
    beams per row."""

    def __init__(self, model: nn.Module, gen_cfg: GenerateConfig,
                 length_penalty: float = 1.0, *,
                 device: Union[str, torch.device] = "cuda"):
        if gen_cfg.num_beams <= 1:
            raise ValueError("beam search needs num_beams > 1")
        self.model = model
        self.cfg = gen_cfg
        self.length_penalty = length_penalty
        self.device = torch.device(device)

    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t.to(self.device, dtype) if dtype else t.to(self.device)

    @torch.no_grad()
    def _prefill(self, ids, images, mask, cache):
        b, s = ids.shape
        kwargs = {"images": self._as_tensor(images)} \
            if images is not None else {}
        positions = torch.arange(s, device=self.device).expand(b, s)
        logits, cache = self.model(
            ids, segment_ids=mask.to(torch.int32), positions=positions,
            kv_cache=cache, **kwargs)
        lengths = mask.sum(dim=1)
        last = logits[torch.arange(b, device=self.device), lengths - 1]
        return last, cache, lengths

    @torch.no_grad()
    def search(self, input_ids, *, images=None, attention_mask=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns the best sequence of each row, (b, max_new_tokens) int32
        (pad after a banked stop token, which is included), and its
        normalized score, (b,) float32."""
        cfg = self.cfg
        k, T, lp = cfg.num_beams, cfg.max_new_tokens, self.length_penalty
        dev = self.device
        ids = self._as_tensor(input_ids, torch.int64)
        mask = (ids != cfg.pad_id) if attention_mask is None else \
            self._as_tensor(attention_mask, torch.bool)
        b, s = ids.shape
        model_cfg = self.model.cfg
        lm_cfg = model_cfg.lm if hasattr(model_cfg, "lm") else model_cfg
        cache = init_kv_cache(lm_cfg, b, s + T, dtype=cfg.cache_dtype,
                              device=dev)
        first, cache, lengths = self._prefill(ids, images, mask, cache)

        # the candidate pool: even if every stop id lands in the top ranks,
        # k non-stop candidates remain to refill the running beams
        n_cand = max(2, 2 + len(cfg.stop_token_ids)) * k
        V = first.shape[-1]
        if n_cand > V:
            raise ValueError(f"needs vocab >= {n_cand} for {k} beams")
        stop_ids = torch.tensor((cfg.eos_id,) + tuple(cfg.stop_token_ids),
                                device=dev)
        logits = first.repeat_interleave(k, dim=0)              # (b*k, V)
        # (b, ...) -> (b*k, ...): row i's beams all read prompt row i
        cache = _gather_beams(cache, torch.zeros((b, k), dtype=torch.int64,
                                                 device=dev), b, 1)
        lengths = lengths.repeat_interleave(k)
        # beam 0 live, the others start at NEG_INF so step 1 fans out
        alive_scores = torch.tensor([0.0] + [NEG_INF] * (k - 1),
                                    device=dev).repeat(b, 1)
        alive_seqs = torch.full((b, k, T), cfg.pad_id, dtype=torch.int32,
                                device=dev)
        fin_scores = torch.full((b, k), NEG_INF, device=dev)
        fin_seqs = torch.full((b, k, T), cfg.pad_id, dtype=torch.int32,
                              device=dev)
        done_b = torch.zeros(b, dtype=torch.bool, device=dev)
        rank_ok = torch.arange(n_cand, device=dev)[None] < k

        def gather_seqs(seqs, index):
            return torch.gather(seqs, 1, index[..., None].expand(
                -1, -1, seqs.shape[2]))

        for i in range(T):
            logprobs = torch.log_softmax(logits.float(), dim=-1).reshape(
                b, k, V)
            total = alive_scores[..., None] + logprobs          # (b, k, V)
            s2k, i2k = _top_k(total.reshape(b, k * V), n_cand)
            beam2k = i2k // V
            tok2k = (i2k % V).to(torch.int32)
            is_eos = torch.isin(tok2k, stop_ids)
            seq2k = gather_seqs(alive_seqs, beam2k)             # (b, 2k, T)
            seq2k[:, :, i] = tok2k

            # bank stop candidates in the top k ranks, normalized by the
            # generated length counting the stop token (i + 1)
            bankable = is_eos & rank_ok & ~done_b[:, None]
            norm2k = s2k / max(i + 1.0, 1.0) ** lp
            bank = torch.where(bankable, norm2k, NEG_INF)
            fin_scores, fin_idx = _top_k(
                torch.cat([fin_scores, bank], dim=1), k)
            fin_seqs = gather_seqs(torch.cat([fin_seqs, seq2k], dim=1),
                                   fin_idx)

            # refill the running beams from the best non-stop candidates
            alive_scores, pick = _top_k(
                torch.where(is_eos, NEG_INF, s2k), k)
            beam_sel = torch.gather(beam2k, 1, pick)
            alive_seqs = gather_seqs(seq2k, pick)
            tok_sel = torch.gather(tok2k, 1, pick)
            tok_sel = torch.where(done_b[:, None], cfg.pad_id, tok_sel)

            # done: k hypotheses banked and the best running beam, at the
            # current generated length, cannot beat the worst of them
            worst_fin = fin_scores[:, k - 1]
            best_possible = alive_scores[:, 0] / max(i + 1.0, 1.0) ** lp
            done_b = done_b | ((worst_fin > NEG_INF / 2)
                               & (worst_fin >= best_possible))
            # the host reads `done_b` once a step, as the while_loop's
            # condition does on the device; the last step's forward is
            # skipped, since no step reads its logits
            if i + 1 == T or bool(done_b.all()):
                break
            cache = _gather_beams(cache, beam_sel, b, k)
            logits, cache = self.model(
                tok_sel.reshape(b * k, 1).long(),
                positions=lengths[:, None], kv_cache=cache)
            logits = logits[:, 0]
            lengths = lengths + 1

        # rows not done add their running beams at the final length
        alive_norm = alive_scores / max(float(T), 1.0) ** lp
        alive_norm = torch.where(done_b[:, None], NEG_INF, alive_norm)
        all_scores = torch.cat([fin_scores, alive_norm], dim=1)
        all_seqs = torch.cat([fin_seqs, alive_seqs], dim=1)
        best = torch.argmax(all_scores, dim=1)
        seqs = all_seqs[torch.arange(b, device=dev), best]
        scores = all_scores[torch.arange(b, device=dev), best]
        return seqs.cpu().numpy(), scores.cpu().numpy()

    def __call__(self, input_ids, *, images=None,
                 attention_mask=None) -> np.ndarray:
        """Batch beam search: the best sequence of each row,
        (b, max_new_tokens) int32."""
        return self.search(input_ids, images=images,
                           attention_mask=attention_mask)[0]
