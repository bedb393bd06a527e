"""Unified eval entry point (counterpart of ``merlin_tpu/engine/eval.py``):
one CLI over the six benchmark harnesses (the reference launches each
engine/eval/eval*.py separately; eval.sh:1-28).

    python -m merlin_tpu_torch.engine.eval --benchmark mmbench \\
        --eval_file mmbench_dev.tsv --eval_output out/mmbench.json \\
        --model_name_or_path ... --pretrain_model ckpt.bin

The model runs on the card unless ``--device cpu`` is given (with
``--tiny`` for a test-sized model).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from merlin_tpu_torch.eval.runner import EvalConfig
from merlin_tpu_torch.models.builder import (
    build_model_tokenizer, init_or_load_params)
from merlin_tpu_torch.train.arguments import parse_args
from merlin_tpu_torch.utils.logging import setup_logger

BENCHMARKS = ("mmbench", "mmvet", "docvqa", "single", "box", "tracking")


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--benchmark", required=True, choices=BENCHMARKS)
    p.add_argument("--question", default=None, help="for --benchmark single")
    p.add_argument("--image", default=None, help="for --benchmark single")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--max-videos", type=int, default=0)
    p.add_argument("--num-chunks", type=int, default=1,
                   help="tracking: shard videos across workers")
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--merge-chunks", action="store_true",
                   help="tracking: aggregate chunk pickles, no model run")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cpu for a test)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="greedy-exact prompt-lookup speculative decode "
                        "with K-token drafts (greedy single-beam runs "
                        "only; see generate/speculative.py)")
    args, rest = p.parse_known_args(argv)
    margs, dargs, targs = parse_args(rest)
    logger = setup_logger(None, 0)

    if args.benchmark == "tracking" and args.merge_chunks:
        from merlin_tpu_torch.eval import tracking
        out = dargs.eval_output or "output/tracking.json"
        result = tracking.merge_chunks(out)
        logger.info("tracking merged: %s", result)
        return result

    bundle = build_model_tokenizer(margs, dargs, targs, tiny=args.tiny)
    init_or_load_params(bundle, composite_checkpoint=margs.pretrain_model,
                        device=args.device)

    use_spec = (args.speculative and not dargs.use_beam_search)
    if use_spec:
        # speculative is greedy-exact vs GREEDY decoding — it also turns
        # sampling OFF, which changes answers vs a default (sampled) run
        logger.warning("--speculative forces greedy decoding "
                       "(do_sample=False); scores are comparable to other "
                       "greedy runs, not to sampled ones")
    cfg = EvalConfig(num_beams=5 if dargs.use_beam_search else 1,
                     do_sample=not dargs.use_beam_search and not use_spec,
                     image_aspect_ratio=dargs.image_aspect_ratio,
                     speculative=args.speculative if use_spec else 0)
    out = dargs.eval_output or f"output/{args.benchmark}.json"
    dev = dict(device=args.device)

    if args.benchmark == "mmbench":
        from merlin_tpu_torch.eval import mmbench
        result = mmbench.run(bundle, dargs.eval_file, out, cfg,
                             limit=args.limit, **dev)
    elif args.benchmark == "mmvet":
        from merlin_tpu_torch.eval import mmvet
        result = mmvet.run(bundle, dargs.eval_file, dargs.eval_image_dir,
                           out, cfg, limit=args.limit, **dev)
    elif args.benchmark == "docvqa":
        from merlin_tpu_torch.eval import docvqa
        result = docvqa.run(bundle, dargs.eval_file, dargs.eval_image_dir,
                            out, cfg, limit=args.limit, **dev)
    elif args.benchmark == "single":
        from merlin_tpu_torch.eval import single
        result = single.run(bundle, args.image, args.question, cfg, **dev)
    elif args.benchmark == "box":
        from merlin_tpu_torch.eval import box_eval
        box_eval.run_repl(bundle, cfg, **dev)
        result = None
    else:  # tracking
        from merlin_tpu_torch.eval import tracking
        result = tracking.run(bundle, dargs.eval_image_dir, out, cfg,
                              max_videos=args.max_videos,
                              num_chunks=args.num_chunks,
                              chunk_idx=args.chunk_idx, **dev)
    logger.info("%s result: %s", args.benchmark, result)
    return result


if __name__ == "__main__":
    main()
