#!/usr/bin/env bash
# CI-style gate: full test suite on the 8-device virtual CPU mesh, a small
# CPU bench sanity run (one JSON line), a CLI render smoke, and the driver
# entry points. No GPU required.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== pytest =="
python -m pytest tests/ -q

echo "== bench (cpu, small) =="
RAYSNAIL_BENCH_CPU=1 RAYSNAIL_BENCH_SMALL=1 python bench.py | tail -1 | python -c "
import json, sys
d = json.loads(sys.stdin.read())
assert {'metric', 'value', 'unit', 'vs_baseline'} <= set(d), d
print('bench line ok:', d)
"

echo "== cli smoke =="
tmp=$(mktemp -d)
python - <<EOF
import sys
sys.argv = ['raysnail_tpu', '--scene', 'sdl/example.sdl', '-w', '60',
            '--height', '40', '--samples', '4', '--cpu',
            '-o', '$tmp/out.png']
import runpy
runpy.run_module('raysnail_tpu', run_name='__main__')
EOF
test -s "$tmp/out.png"

echo "== graft entry (single-device compile + 8-device CPU mesh dryrun) =="
XLA_FLAGS="--xla_force_host_platform_device_count=8" python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
print("entry ok")
g.dryrun_multichip(8)
EOF

echo "CI OK"
