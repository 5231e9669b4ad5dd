#!/usr/bin/env bash
# Compare the machine code (SASS) nvcc makes of one kernel source in this
# tree and in another revision's csrc directory, symbol hashes and
# addresses aside. Needs the CUDA toolkit (nvcc, cuobjdump).
#
#   tools/sass_diff.sh _checkout/<rev>/src/repro_torch/kernels/vbyte_decode/csrc [fused_decode]
set -euo pipefail
other=$1
name=${2:-fused_decode}
here=$(cd "$(dirname "$0")/.." && pwd)/src/repro_torch/kernels/vbyte_decode/csrc
cuda=${CUDA_HOME:-/usr/local/cuda}
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
for side in this other; do
  dir=$here
  [ "$side" = other ] && dir=$other
  "$cuda/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
    -cubin -o "$tmp/$side.cubin" "$dir/$name.cu"
  "$cuda/bin/cuobjdump" -sass "$tmp/$side.cubin" |
    sed -E 's/_GLOBAL__N__[0-9A-Za-z_]+//g; s/\/\*[0-9a-f]{4,}\*\///g' |
    grep -v '^\s*$' > "$tmp/$side.sass"
done
if cmp -s "$tmp/this.sass" "$tmp/other.sass"; then
  echo "$name: SASS identical ($(wc -l < "$tmp/this.sass") lines)"
else
  echo "$name: SASS differs"
  diff "$tmp/this.sass" "$tmp/other.sass" | head -20
  exit 1
fi
