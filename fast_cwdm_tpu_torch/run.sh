#!/bin/bash
# Master launcher of the PyTorch/CUDA port: the flags of the JAX package's
# run.sh, running the port's CLIs (python -m fast_cwdm_tpu_torch.cli.*)
# from the repository root, on the GPU.
#
#   --mode {train,sample,auto,complete}   (default train)
#   --sampling-strategy {direct,sampled}  (default direct)
#   --timesteps N                         (default 1000)
#   --train_modality {t1n,t1c,t2w,t2f,all}
# plus --data_dir / --val_dir / --checkpoint_dir / --output_dir overrides,
# and --extra "..." forwarded verbatim to the CLI of every mode, e.g.
#   --extra "--lr_anneal_steps=4 --log_interval=1"   (train)
#   --extra "--sampler=dpm++ --sampling_steps=10"    (complete, sample)
# Each mode prints a [TIMING] banner as the reference's run.sh does.

set -e
cd "$(dirname "$0")/.."

SAMPLING_STRATEGY="direct"
TIMESTEPS=""
MODE="train"
TRAIN_MODALITY="t1n"
DATA_DIR="${DATA_DIR:-./datasets/BRATS2023/training}"
VAL_DIR="${VAL_DIR:-./datasets/BRATS2023/validation}"
CHECKPOINT_DIR="${DIFFUSION_BLOB_LOGDIR:-./checkpoints}"
OUTPUT_DIR="./results"
EXTRA=""

while [[ $# -gt 0 ]]; do
  case $1 in
    --mode) MODE="$2"; shift 2 ;;
    --sampling-strategy) SAMPLING_STRATEGY="$2"; shift 2 ;;
    --timesteps) TIMESTEPS="$2"; shift 2 ;;
    --train_modality) TRAIN_MODALITY="$2"; shift 2 ;;
    --data_dir) DATA_DIR="$2"; shift 2 ;;
    --val_dir) VAL_DIR="$2"; shift 2 ;;
    --checkpoint_dir) CHECKPOINT_DIR="$2"; shift 2 ;;
    --output_dir) OUTPUT_DIR="$2"; shift 2 ;;
    --extra) EXTRA="$2"; shift 2 ;;
    --help)
      echo "Usage: $0 [--mode MODE] [--sampling-strategy STRATEGY] [--timesteps STEPS] [--train_modality MODALITY]"
      echo "  --mode: train, sample, auto, complete (default: train)"
      echo "  --sampling-strategy: direct or sampled (default: direct)"
      echo "  --timesteps: number of diffusion steps (default: 1000)"
      echo "  --train_modality: t1n, t1c, t2w, t2f, all (default: t1n)"
      echo "  --data_dir, --val_dir, --checkpoint_dir, --output_dir: directory overrides"
      echo "  --extra \"FLAGS\": forwarded verbatim to the CLI"
      exit 0 ;;
    *) echo "Unknown option $1"; exit 1 ;;
  esac
done

if [[ -z "$TIMESTEPS" ]]; then TIMESTEPS=1000; fi
SEED=42
export DIFFUSION_BLOB_LOGDIR="$CHECKPOINT_DIR"

# production model preset (the reference's run.sh)
COMMON="--dims=3 --num_groups=32 --num_channels=64 --num_res_blocks=2
  --channel_mult=1,2,2,4,4 --attention_resolutions= --bottleneck_attention=False
  --image_size=112 --in_channels=32 --out_channels=8 --resample_2d=False
  --use_scale_shift_norm=False --additive_skips=False
  --diffusion_steps=$TIMESTEPS --sample_schedule=$SAMPLING_STRATEGY
  --noise_schedule=linear --predict_xstart=True --mode=i2i --dataset=brats
  --dtype=bfloat16"
# use_checkpoint recomputes the level-0/1 ResBlocks in the backward pass:
# on an H100 80GB HBM3 (700 W) a production step peaks at 16.0 GB with it
# and 28-29 GB without (PERF.md, PR 7), leaving room for a device-cached
# dataset
TRAIN="--data_dir=$DATA_DIR --lr=1e-5 --batch_size=1 --log_interval=100
  --save_interval=50 --lr_anneal_steps=5000 --use_checkpoint=True
  --num_workers=12 --checkpoint_dir=$CHECKPOINT_DIR"
SAMPLE="--data_dir=$VAL_DIR --output_dir=$OUTPUT_DIR --seed=$SEED"

train_one() {
  local CONTRAST=$1
  echo "=== Training $CONTRAST ($SAMPLING_STRATEGY, $TIMESTEPS steps) ==="
  local START=$(date +%s)
  python -m fast_cwdm_tpu_torch.cli.train $TRAIN --contr=$CONTRAST $COMMON $EXTRA
  local END=$(date +%s)
  echo "[TIMING] Training for $CONTRAST completed in $((END-START)) seconds"
}

case $MODE in
  train)
    if [[ "$TRAIN_MODALITY" == "all" ]]; then
      for CONTRAST in t1n t1c t2w t2f; do train_one $CONTRAST; done
    else
      train_one $TRAIN_MODALITY
    fi ;;
  sample)
    START=$(date +%s)
    CKPT=$(ls -t "$CHECKPOINT_DIR"/brats_${TRAIN_MODALITY}_BEST_*.ckpt 2>/dev/null | head -1)
    if [[ -z "$CKPT" ]]; then echo "no checkpoint for $TRAIN_MODALITY in $CHECKPOINT_DIR"; exit 1; fi
    python -m fast_cwdm_tpu_torch.cli.sample $SAMPLE --contr=$TRAIN_MODALITY --model_path="$CKPT" $COMMON $EXTRA
    END=$(date +%s)
    echo "[TIMING] Sampling completed in $((END-START)) seconds" ;;
  auto)
    START=$(date +%s)
    python -m fast_cwdm_tpu_torch.cli.sample_auto --data_dir=$VAL_DIR --output_dir=$OUTPUT_DIR \
      --checkpoint_dir=$CHECKPOINT_DIR --seed=$SEED $COMMON $EXTRA
    END=$(date +%s)
    echo "[TIMING] Sampling completed in $((END-START)) seconds" ;;
  complete)
    START=$(date +%s)
    python -m fast_cwdm_tpu_torch.cli.complete_dataset --input_dir=$VAL_DIR --output_dir=$OUTPUT_DIR \
      --checkpoint_dir=$CHECKPOINT_DIR $EXTRA
    END=$(date +%s)
    echo "[TIMING] Completion finished in $((END-START)) seconds" ;;
  *) echo "Unknown mode $MODE"; exit 1 ;;
esac
