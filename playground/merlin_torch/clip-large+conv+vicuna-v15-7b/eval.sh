#!/bin/bash
# Eval recipes through the PyTorch/CUDA port, on one card: the JAX
# recipe's flags (playground/merlin/.../eval.sh).
CKPT=${CKPT:-output/merlin-sft/checkpoint-final}

python -m merlin_tpu_torch.engine.eval --benchmark mmvet --device cuda \
    --pretrain_model "$CKPT" \
    --eval_file data/mm-vet/mm-vet.json \
    --eval_image_dir data/mm-vet/images \
    --eval_output output/eval/mmvet.json "$@"

python -m merlin_tpu_torch.engine.eval --benchmark mmbench --device cuda \
    --pretrain_model "$CKPT" \
    --use_beam_search True \
    --eval_file data/mmbench/mmbench_dev_20230712.tsv \
    --eval_output output/eval/mmbench.json "$@"

python -m merlin_tpu_torch.engine.eval --benchmark tracking --device cuda \
    --pretrain_model "$CKPT" \
    --eval_image_dir data/lasot \
    --eval_output output/eval/tracking "$@"
