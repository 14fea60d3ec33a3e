#!/bin/bash
# Parent commit against this tree, tracing off, on one card, all in one call:
#
#   mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
#   bash benchmark/parent_pairs.sh all      # or: sample
#
# from the repository's root (build/ is not committed).  `all`: each of the
# four cells as parent, change, change, parent (seeds 3400300000 + 10 i + 1
# and + 2 for the i-th cell, 30 s windows), a traced vit_l_32.sample run on
# each side (seed 3400300091), then span_probe.py on every cell (one traced
# run each way, no pairs).  `sample`: four rounds over the two sampling
# cells, the order alternating (change first in odd rounds), seed
# 3400400000 + 100 k + the cell name's length.  Each run's output goes to
# $OUT/<side>.<cell>.<seed>.<trace>.{out,err} (OUT defaults to build/bench);
# one line a run is printed: its exit code, `correct`, `attempted`, `failed`
# and metrics.
set -u
mode=${1:?all or sample}
out=$(realpath -m "${OUT:-build/bench}")
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {  # side cell seed trace
  local dir=.
  [ "$1" = parent ] && dir=build/parent
  local tag=$out/$1.$2.$3.$4
  (cd $dir && python3 benchmark/run.py --workload $2 --seed $3 --seconds 30 \
    --trace $4) > $tag.out 2> $tag.err
  echo "$1 $2 seed=$3 trace=$4 rc=$?"
  tail -n 1 $tag.out | python3 -c "import sys, json; d = json.loads(sys.stdin.read()); print(' ', json.dumps({k: d[k] for k in ('correct', 'attempted', 'failed')}), json.dumps({k: v['value'] for k, v in d['metrics'].items()}))" || tail -c 800 $tag.err
}
if [ "$mode" = all ]; then
  i=0
  for cell in vit_l_32.sample resnet101.sample vit_l_32.predict \
      resnet101.predict; do
    i=$((i + 1))
    s1=$((3400300000 + i * 10 + 1)); s2=$((3400300000 + i * 10 + 2))
    run parent $cell $s1 0; run change $cell $s1 0
    run change $cell $s2 0; run parent $cell $s2 0
  done
  run change vit_l_32.sample 3400300091 1
  run parent vit_l_32.sample 3400300091 1
  for cell in vit_l_32.sample resnet101.sample vit_l_32.predict \
      resnet101.predict; do
    python3 benchmark/span_probe.py --workload $cell \
      --seed $((3400300100 + ${#cell})) --pairs 0 --traces 1 \
      > "$out/probe_$cell.log" 2> "$out/probe_$cell.err"
    echo "probe $cell rc=$?"
  done
  python3 benchmark/span_probe_summary.py "build/span_probe/*340030010*.json"
else
  for k in 1 2 3 4; do
    for cell in vit_l_32.sample resnet101.sample; do
      s=$((3400400000 + k * 100 + ${#cell}))
      if [ $((k % 2)) = 1 ]; then run change $cell $s 0; run parent $cell $s 0
      else run parent $cell $s 0; run change $cell $s 0; fi
    done
  done
fi
