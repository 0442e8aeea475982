#!/bin/bash
# Two sets of runs of one cell with the same seeds, as the bounds are set
# from: one compiling run first (recorded apart), then each set in turn.
#   bash bench/tools/sets.sh <cell> <seconds> <out.jsonl> <seed> [<seed> ...]
cell=$1; secs=$2; out=$3; shift 3
mkdir -p "$(dirname "$out")"
err="$out.stderr"
run() {  # set seed trace
  local all rc line
  all=$(python3 bench/run.py --workload "$cell" --seed "$2" --seconds "$secs" \
        --trace "$3" 2>>"$err"); rc=$?
  line=$(printf '%s\n' "$all" | tail -n 1)
  [ $rc -eq 0 ] || line=null
  echo "{\"set\": \"$1\", \"seed\": $2, \"trace\": $3, \"rc\": $rc, \"line\": ${line:-null}}" >> "$out"
}
secs_all=$secs; secs=5; run first 1 0; secs=$secs_all
for s in 1 2; do for seed in "$@"; do run "$s" "$seed" 0; done; done
