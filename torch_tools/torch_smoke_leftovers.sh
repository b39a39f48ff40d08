#!/bin/bash
# Runs chip_smoke.py in a session of its own and lists what of that session
# still runs when the script has exited: right away and 2 s later. Exits
# with the script's code, or 1 if a process of its session is left.
#
#   bash torch_tools/torch_smoke_leftovers.sh [DIR]
#
# DIR holds the chip_smoke.py to run (default: the repository root), e.g. a
# `git archive` of the tree unpacked into a git-ignored directory. The
# script's output goes to chiprun_out/smoke.log and smoke.err, the listings
# to chiprun_out/left_0s.txt and left_2s.txt.
root=$(cd "$(dirname "$0")/.." && pwd)
dir=$(cd "${1:-$root}" && pwd)
out=$root/chiprun_out
mkdir -p "$out"
cd "$dir"
setsid python3 chip_smoke.py > "$out/smoke.log" 2> "$out/smoke.err" &
pid=$!
wait $pid
rc=$?
left() {
    ps -eo pid,ppid,pgid,sid,stat,etime,args | awk -v s=$pid 'NR==1 || $4==s'
}
left > "$out/left_0s.txt"
sleep 2
left > "$out/left_2s.txt"
echo "chip_smoke.py exit $rc"
for t in 0s 2s; do
    echo "== its session at $t after the exit"
    cat "$out/left_$t.txt"
done
echo "== last lines"
tail -n 3 "$out/smoke.log" | cut -c1-600
grep -E "^(build:|hapi_[a-z0-9]+: [^{]|chip_smoke:)" "$out/smoke.log" | cut -c1-400
tail -n 20 "$out/smoke.err"
if [ "$(wc -l < "$out/left_0s.txt")" -gt 1 ]; then
    echo "processes left running"
    exit 1
fi
exit $rc
