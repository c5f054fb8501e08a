#!/usr/bin/env bash
# The α 0.985 deep-thinning run of docs/BENCH.md:283-290 through the port's
# train and validate CLIs on the CUDA card: the recipe of
# examples/thinning_orsirr_torch.py (terminal bias 0 included) with α 0.985,
# demonstrations 0.2 / 0.3 / 0.4, a 5,000-step warm start and 1,500 SubTB
# epochs, then validate (GMRES: none, ILU(0), sampled and classic k = 2 SPAI).
# Prints the card's name and power limit first, and every line of the run
# with the seconds since its start.  With COPY_TO, the run's metrics.jsonl,
# training_log.csv, validation.json and this log are copied there (no
# checkpoint).
#
#     bash examples/thinning_a985_torch.sh [RUN=runs/torch_thin_orsirr150_a985] [COPY_TO]
set -euo pipefail
run=${1:-runs/torch_thin_orsirr150_a985}
copy=${2:-}
recipe=(--matrix orsirr_like150 --seed-method spai --seed-k 2 --reward-baseline identity
        --loss subtb --subtb-lambda 1.0 --backward linear --replay-size 32
        --replay-samples 4 --replay-prioritized 1.0 --alpha-fixed 0.985 --lr 1e-3
        --plateau-patience 0 --reward-beta 50 --edge-feats
        --replay-seed-thinning 0.2,0.3,0.4 --t-cap 163840)
log=$(mktemp)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$log"
start=$(date +%s%3N)
{
    python -m gflownet_spai_tpu_torch.train "${recipe[@]}" --warmstart-epochs 5000 \
        --epochs 1500 --batch-size 16 --checkpoint-every 500 --log-every 50 \
        --out-dir "$run" --terminal-bias 0
    python -m gflownet_spai_tpu_torch.validate "${recipe[@]}" --classic-k 2 \
        --wall-repeats 3 --from-checkpoint "$run" --final-samples 128 \
        --out-dir "${run}_val"
} 2>&1 |
    while IFS= read -r line; do
        now=$(date +%s%3N)
        printf '%8d.%03d %s\n' $(((now - start) / 1000)) $(((now - start) % 1000)) "$line"
    done | tee -a "$log"
if [ -n "$copy" ]; then
    mkdir -p "$copy/$(basename "$run")" "$copy/$(basename "$run")_val"
    cp "$run/metrics.jsonl" "$run/training_log.csv" "$copy/$(basename "$run")/"
    cp "${run}_val/validation.json" "$copy/$(basename "$run")_val/"
    cp "$log" "$copy/$(basename "$run").log"
fi
rm -f "$log"
