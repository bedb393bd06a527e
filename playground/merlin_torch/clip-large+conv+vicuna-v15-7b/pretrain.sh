#!/bin/bash
# Merlin pretrain recipe on one host of 8 H100s, through the PyTorch/CUDA
# port: the JAX recipe's flags (playground/merlin/.../pretrain.sh), one
# process a card under torchrun; --mesh_fsdp 8 shards the parameters over
# the 8 processes (FSDP2).
export MERLIN_DATA_ROOT=${MERLIN_DATA_ROOT:-/data/merlin}

torchrun --nproc_per_node 8 -m merlin_tpu_torch.engine.train \
    --model_name_or_path lmsys/vicuna-7b-v1.5 \
    --vision_tower openai/clip-vit-large-patch14 \
    --projector conv --conv_stride 2 \
    --pair_datasets laion2b_10m_6merge \
    --interpair_datasets track_1m_v2_2merge+det_5m_v1_en_4merge \
    --image_size 448 --image_aspect_ratio resize \
    --model_max_length 2048 \
    --per_device_train_batch_size 1 --gradient_accumulation_steps 8 \
    --learning_rate 5e-5 --adam_beta2 0.95 --weight_decay 0.05 \
    --warmup_ratio 0.01 --lr_scheduler_type cosine \
    --llrd True --llm_llrd False \
    --bf16 True --gradient_checkpointing True \
    --mesh_data -1 --mesh_fsdp 8 --mesh_tensor 1 \
    --save_steps 500 --save_total_limit 2 --logging_steps 1 \
    --dataloader_num_workers 4 \
    --output_dir output/merlin-pretrain "$@"
