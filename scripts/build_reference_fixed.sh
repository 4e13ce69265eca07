#!/bin/bash
# Build the reference binary with a ONE-LINE fix for the OLabel GC bug its
# stock build hits at large-vocab scale (discovered round 4, see
# docs/DEBUG.md, the reference GC bug):
#
#   /root/reference/src/pool.h GCPool::GC bounds both the unmark and the
#   sweep loop with `current_pos_ - 1`, skipping the LAST bump-allocated
#   pool slot.  A skipped node keeps a stale kMarked state from an earlier
#   GC; the mark traversal then stops at it ("already marked") WITHOUT
#   marking its ancestors, which get swept while still reachable from live
#   tokens.  BestPath later walks the dangling previous_ chain into a
#   freed node (OnCollect sets olabel_ = -1) and SymbolTable::Get(-1)
#   aborts.  Trigger needs the skipped slot to stay put across GCs (all
#   allocations served from the free list — i.e. heavy olabel churn:
#   big-vocab decodes); small graphs never hit it.
#
# The fix changes the loop bound to `current_pos_` (cover every allocated
# slot).  Verified: 8/20 crashing 50k-word decodes all pass with only this
# change (scripts/realism.py).
set -e
REF=${1:-/root/reference}
OUT=${2:-/tmp/refbuild_fixed}
SRC="$OUT/src_patched"
rm -rf "$SRC"
mkdir -p "$OUT"
cp -r "$REF" "$SRC"
python3 - "$SRC/src/pool.h" <<'EOF'
import sys
p = sys.argv[1]
s = open(p).read()
n = s.count("this->current_pos_ - 1")
assert n == 2, f"expected 2 occurrences, found {n}"
open(p, "w").write(s.replace("this->current_pos_ - 1",
                             "this->current_pos_"))
EOF
bash "$(dirname "$0")/build_reference.sh" "$SRC" "$OUT"
