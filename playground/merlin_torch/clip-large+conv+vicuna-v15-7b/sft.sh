#!/bin/bash
# Merlin SFT recipe on one host of 8 H100s, through the PyTorch/CUDA port:
# the JAX recipe's flags (playground/merlin/.../sft.sh), conversation data
# from the pretrain checkpoint, vision tower frozen; one process a card
# under torchrun, --mesh_fsdp 8 shards the parameters over them.
export MERLIN_DATA_ROOT=${MERLIN_DATA_ROOT:-/data/merlin}

torchrun --nproc_per_node 8 -m merlin_tpu_torch.engine.train \
    --model_name_or_path lmsys/vicuna-7b-v1.5 \
    --pretrain_model output/merlin-pretrain/checkpoint-final \
    --vision_tower openai/clip-vit-large-patch14 \
    --projector conv --conv_stride 2 \
    --conversation_datasets llava665k_refine+track_sft_v2 \
    --freeze_vision_tower True \
    --image_size 448 --image_aspect_ratio resize \
    --model_max_length 2048 \
    --per_device_train_batch_size 8 --gradient_accumulation_steps 1 \
    --learning_rate 4e-5 --adam_beta2 0.95 --weight_decay 0.05 \
    --warmup_ratio 0.03 --lr_scheduler_type cosine \
    --group_by_modality_length True \
    --bf16 True --gradient_checkpointing True \
    --mesh_data -1 --mesh_fsdp 8 --mesh_tensor 1 \
    --save_steps 1000 --save_total_limit 2 --logging_steps 1 \
    --output_dir output/merlin-sft "$@"
