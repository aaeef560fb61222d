#!/bin/bash
# Seed-0 quality runs of several source trees ("arms") on the card, one
# after another, each run's checkpoints then scored again by other trees'
# `quality_run --skip_train` (training told apart from sampling).
#
#   tools/quality_arms.sh TREES LOG_PREFIX TAG [TAG ...]
#
# TREES holds one unpacked tree a directory (e.g. `git archive` of a commit,
# patched or not). A TAG's first letter names the arm's directory, the rest
# tells its runs apart (B1, B2, A1 ...). SCORERS (default "A p9"; empty: none) names the
# trees that score every run's checkpoints. Logs go to LOG_PREFIX_TAG.log and
# LOG_PREFIX_TAG_by_SCORER.log; each run's workdir, TREES/wd_TAG, is removed
# after its scoring. The run: `quality_run --bf16 --ess --n_eval 1024
# --seed 0` (QR_FLAGS overrides it).
set -u
trees=$(cd "$1" && pwd); prefix=$2; shift 2
mkdir -p "$(dirname "$prefix")"; prefix=$(cd "$(dirname "$prefix")" && pwd)/$(basename "$prefix")
flags=${QR_FLAGS:-"--bf16 --ess --n_eval 1024 --seed 0"}
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
for tag in "$@"; do
  arm=${tag:0:1}
  wd=$trees/wd_$tag
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  t0=$(date +%s)
  (cd "$trees/$arm" && python -m tvqvae_tpu_torch.scripts.quality_run --workdir "$wd" $flags \
     > "${prefix}_$tag.log" 2>&1)
  echo "run $tag rc=$? wall_s=$(( $(date +%s) - t0 ))"
  grep -a "SUMMARY" "${prefix}_$tag.log" | tail -1
  grep -a "stage_minutes" "${prefix}_$tag.log" | tail -1 | cut -c1-260
  for scorer in ${SCORERS-A p9}; do
    t0=$(date +%s)
    (cd "$trees/$scorer" && python -m tvqvae_tpu_torch.scripts.quality_run --workdir "$wd" $flags \
       --skip_train > "${prefix}_${tag}_by_$scorer.log" 2>&1)
    echo "score $tag by $scorer rc=$? wall_s=$(( $(date +%s) - t0 ))"
    grep -a "SUMMARY" "${prefix}_${tag}_by_$scorer.log" | tail -1
  done
  rm -rf "$wd"
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
