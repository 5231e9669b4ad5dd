#!/usr/bin/env bash
# Compare the machine code (SASS) nvcc makes of one kernel source in this
# tree and in another revision's csrc directory, kernel by kernel, symbol
# hashes and addresses aside: one line per kernel (demangled, named
# without its parameter list), saying whether its SASS is identical,
# differs, or exists on one side only, then a count. Exits 1 if any kernel
# changed. Needs the CUDA toolkit (nvcc, cuobjdump, cu++filt).
#
#   tools/sass_diff.sh _checkout/<rev>/src/repro_torch/kernels/vbyte_decode/csrc [fused_decode]
set -euo pipefail
other=$1
name=${2:-fused_decode}
here=$(cd "$(dirname "$0")/.." && pwd)/src/repro_torch/kernels/vbyte_decode/csrc
cuda=${CUDA_HOME:-/usr/local/cuda}
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
declare -A this_of other_of
for side in this other; do
  dir=$here
  [ "$side" = other ] && dir=$other
  mkdir "$tmp/$side"
  "$cuda/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
    -cubin -o "$tmp/$side.cubin" "$dir/$name.cu"
  # kernel k's SASS to $side/k, its mangled symbol to $side/k.sym
  "$cuda/bin/cuobjdump" -sass "$tmp/$side.cubin" |
    awk -v d="$tmp/$side" '/Function : /{f = d "/" (++k); print $NF > (f ".sym"); next}
                           f {print > f}'
  for sym in "$tmp/$side"/*.sym; do
    [ -e "$sym" ] || continue
    f=${sym%.sym}
    # demangled, without its parameter list (a kernel whose parameters
    # changed is still the same kernel)
    label=$("$cuda/bin/cu++filt" "$(cat "$sym")" |
            sed -E 's/\(anonymous namespace\):://g; s/<unnamed>:://g; s/\([^()]*\)$//')
    sed -E -i 's/_GLOBAL__N__[0-9A-Za-z_]+//g; s/\/\*[0-9a-f]{4,}\*\///g; /^\s*$/d' "$f"
    if [ "$side" = this ]; then this_of[$label]=$f; else other_of[$label]=$f; fi
  done
done
changed=0
total=0
while IFS= read -r label; do
  [ -n "$label" ] || continue
  total=$((total + 1))
  a=${this_of[$label]:-}
  b=${other_of[$label]:-}
  if [ -z "$b" ]; then
    echo "CHANGED    $label: only in this tree"
  elif [ -z "$a" ]; then
    echo "CHANGED    $label: only in the other tree"
  elif cmp -s "$a" "$b"; then
    echo "identical  $label ($(wc -l < "$a") lines)"
    continue
  else
    echo "CHANGED    $label: $(wc -l < "$b") -> $(wc -l < "$a") lines"
  fi
  changed=$((changed + 1))
done < <(printf '%s\n' "${!this_of[@]}" "${!other_of[@]}" | sort -u)
echo "$name: $changed of $total kernels changed"
[ "$changed" -eq 0 ]
