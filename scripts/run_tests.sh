#!/usr/bin/env bash
# Per-file test runner with one retry per file.
#
# Running each test file in its own process bounds XLA:CPU compiler state,
# and one retry absorbs a rare compiler crash. A file failing twice is a
# real failure.
set -u
cd "$(dirname "$0")/.."
fail=0
# Optional CPU-yield gate: with YIELD_WHILE=<file> set, pause between test
# files while <file> exists (keeps the cores free for another measurement).
gate() {
  [ -n "${YIELD_WHILE:-}" ] || return 0
  while [ -e "$YIELD_WHILE" ]; do sleep 60; done
}
for f in tests/test_*.py; do
  gate
  for attempt in 1 2; do
    python -m pytest "$f" -q --no-header -p no:cacheprovider
    code=$?
    if [ $code -eq 0 ]; then
      break
    fi
    if [ $attempt -eq 2 ]; then
      echo "FAILED twice: $f (exit $code)"
      fail=1
    else
      echo "retrying $f (exit $code)..."
    fi
  done
done
exit $fail
