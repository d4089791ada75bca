# Two sets of runs of one cell with the same seeds, as the bounds are set,
# the sets interleaved seed by seed (A s1, B s1, A s2, ...) so that a
# drift of the host's speed over the call falls on both alike:
#   bash perfbench/sets.sh OUTDIR SECONDS CELL SEED...
# writes OUTDIR/<A|B>_<cell>_<seed>.{out,err}; then
#   python3 -m perfbench.spreads OUTDIR
out=$1; sec=$2; w=$3; shift 3
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
mkdir -p "$out"
for s in "$@"; do
  for set in A B; do
    timeout 400 python3 -m perfbench.run --workload "$w" --seed "$s" \
      --seconds "$sec" --trace 0 > "$out/${set}_${w}_$s.out" \
      2> "$out/${set}_${w}_$s.err"
    echo "$set $w $s rc=$? $(grep '^window' "$out/${set}_${w}_$s.err")"
  done
done
