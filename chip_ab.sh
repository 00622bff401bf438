#!/bin/bash
# Run one mode of chip_smoke.py over several trees in turn on one host, to
# compare two commits on the same card in one call:
#
#     git archive <parent> | tar -x -C scratch_chip/parent
#     bash chip_ab.sh --fleet-only scratch_chip/parent . . scratch_chip/parent
#
# Every output line is stamped with its second since that run began; run i
# of tree T logs to chiprun_out/ab_<i>_<T's last path part>.log.  Printed:
# each run's wall seconds and its lines matching AB_GREP (default: the
# fleet phase's seconds, the mode's last line and any failure).
cd "$(dirname "$0")" || exit 2
mode=$1
shift
pattern=${AB_GREP:-'fleet: \(a\)-\(d\)|-only: done|FAIL'}
stamp='import sys, time
t0 = time.monotonic()
for line in sys.stdin:
    print("%.2f %s" % (time.monotonic() - t0, line), end="", flush=True)'
mkdir -p chiprun_out
i=0
for tree in "$@"; do
  i=$((i + 1))
  log=chiprun_out/ab_${i}_$(basename "$(cd "$tree" && pwd)").log
  start=$(date +%s.%N)
  (cd "$tree" && python3 chip_smoke.py "$mode" 2>&1) | python3 -c "$stamp" > "$log"
  end=$(date +%s.%N)
  echo "run $i $tree: $(python3 -c "print(round($end - $start, 2))") s"
  grep -E "$pattern" "$log" | tail -3
done
