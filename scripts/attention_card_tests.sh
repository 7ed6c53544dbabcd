#!/bin/bash
# Builds decode.cu and prefill.cu with -Xptxas -v (registers, spills and the
# C7520 advisory into chiprun_out/ptxas_*.txt), then runs the attention
# kernels' card tests (CARD_K selects them). Run on a machine with the card:
#   bash scripts/attention_card_tests.sh
cd "$(dirname "$0")/.."
mkdir -p chiprun_out
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
for f in decode prefill; do
  /usr/local/cuda/bin/nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
    -Xptxas -v -c hpc_ops_tpu_torch/csrc/$f.cu -o /tmp/$f.o > chiprun_out/ptxas_$f.txt 2>&1 &
done
wait
echo "ptxas seconds $(( $(date +%s) - t0 ))"
for f in decode prefill; do
  echo "== $f"; grep -E "error|C7520|spill|Used" chiprun_out/ptxas_$f.txt | sort | uniq -c | sort -rn | head -60
done
timeout ${CARD_TIMEOUT:-900} python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q -p no:cacheprovider \
  --maxfail=25 -k "${CARD_K:-decode or prefill or f5 or splitk or combine or task or e4m3 or nhd_fused or grouped}" \
  2>&1 | tee chiprun_out/card_tests.txt | tail -80
