#!/bin/bash
# chip_smoke.py of two trees in turns on one card, e.g. a parent and a
# change unpacked (git archive) into directories that .gitignore lists:
#
#   STEPS="parent1 change1 cuda change2 parent2 alone" \
#       bash scripts/chip_turns.sh tmp/parent tmp/proof
#
# Each step "parent*" or "change*" runs that tree's chip_smoke.py, its
# output and its clock (standard error) into $OUT/<step>.out/.err (OUT
# default turns_out, relative to the current directory),
# and prints its exit code, its seconds, phase 15's lines and the script's
# last lines; "cuda" runs the change's card tests; "alone" runs the
# change's chip_smoke.py by itself in an empty directory (it must fail).
parent=${1:?parent dir}
change=${2:?change dir}
out=${OUT:-turns_out}
[[ $out == /* ]] || out=$(pwd)/$out
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
run() {
  local t0=$(date +%s)
  (cd "$1" && python3 chip_smoke.py > "$out/$2.out" 2> "$out/$2.err")
  local rc=$?
  echo "$2 rc=$rc seconds=$(( $(date +%s) - t0 ))"
  grep -E "^15\.e|tools phase" "$out/$2.out" | cut -c1-400
  tail -3 "$out/$2.out" | cut -c1-300
}
for step in $STEPS; do
  case $step in
    parent*) run "$parent" "$step" ;;
    change*) run "$change" "$step" ;;
    cuda)
      (cd "$change" && python -m pytest --noconftest -p no:cacheprovider -q \
         tests/test_torch_port_cuda.py > "$out/cuda_tests.out" 2>&1)
      echo "cuda tests rc=$?"; tail -3 "$out/cuda_tests.out" ;;
    alone)
      d=$(mktemp -d) && cp "$change/chip_smoke.py" "$d"/ && (cd "$d" && python3 chip_smoke.py > out.txt 2>&1)
      echo "alone rc=$?"; tail -2 "$d"/out.txt; rm -rf "$d" ;;
  esac
done
