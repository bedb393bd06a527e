#!/bin/bash
# Serving recipe through the PyTorch/CUDA port: controller + one
# continuous-batching worker on one card + web UI, with the JAX recipe's
# flags (playground/merlin/.../serve.sh): the stacked layer layout
# (--scan-decode), 6 slots over an int8 KV pool. Optional levers as
# there: --int8-weights (weight-only int8 LM), --speculative 4.
CKPT=${CKPT:-output/merlin-sft/checkpoint-final}
CONTROLLER=${CONTROLLER:-http://localhost:21001}

python -m merlin_tpu_torch.serve.controller --port 21001 &

python -m merlin_tpu_torch.serve.worker \
    --device cuda \
    --port 21002 \
    --controller-address "$CONTROLLER" \
    --model-path lmsys/vicuna-7b-v1.5 \
    --pretrain_model "$CKPT" \
    --engine --scan-decode \
    --engine-slots 6 \
    --engine-chunk-steps 1 \
    --engine-pipeline 8 \
    --engine-cache-dtype int8 \
    --model_max_length 2048 "$@" &

python -m merlin_tpu_torch.serve.web --port 7860 \
    --controller "$CONTROLLER"
