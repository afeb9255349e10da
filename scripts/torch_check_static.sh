#!/usr/bin/env bash
# The PyTorch port's static-analysis gate: the port's graftlint (the JAX
# package's shared rules and the torch rules), its concurrency model,
# compileall and ruff as one pass/fail. Run from anywhere:
#
#   scripts/torch_check_static.sh      # gate the port, chip_smoke.py and scripts/torch_*.py
#
# ruff is optional (the pinned CPU image does not ship it); when the
# interpreter environment has it, the committed ruff.toml applies.
set -euo pipefail
cd "$(dirname "$0")/.."

# Honor $PYTHON (tests pass sys.executable); fall back for
# python3-only PATHs.
PY="${PYTHON:-$(command -v python || command -v python3)}"

fail=0

# The lint runs in the background beside the other legs (they share
# nothing); its report prints first, once it ends.
lint_log="$(mktemp)"
trap 'rm -f "$lint_log"' EXIT
# Content-hash result cache: warm gate runs re-lint only changed files.
# Override the location with TORCH_GRAFTLINT_CACHE; it is gitignored.
"$PY" scripts/torch_graftlint.py ate_replication_causalml_torch chip_smoke.py scripts/torch_*.py \
    --cache "${TORCH_GRAFTLINT_CACHE:-.torch_graftlint_cache}" > "$lint_log" 2>&1 &
lint_pid=$!

rest="$(
    echo "== torch-graftrace (the port's concurrency model: analysis/concurrency_model.json) =="
    "$PY" scripts/torch_graftrace.py --check 2>&1 || echo "FAILED: torch_graftrace"
    "$PY" scripts/torch_check_concurrency_model.py 2>&1 || echo "FAILED: torch_check_concurrency_model"

    echo "== compileall (syntax gate) =="
    "$PY" -m compileall -q ate_replication_causalml_torch chip_smoke.py scripts/torch_*.py 2>&1 \
        || echo "FAILED: compileall"

    if command -v ruff >/dev/null 2>&1; then
        echo "== ruff (F, E9, B per ruff.toml) =="
        ruff check ate_replication_causalml_torch chip_smoke.py scripts/torch_*.py 2>&1 \
            || echo "FAILED: ruff"
    else
        echo "== ruff not installed; skipping (config: ruff.toml) =="
    fi
)"

echo "== torch-graftlint (shared JGL005-010, JGL012-021; torch TGL001-004, TGL011, TGL022) =="
wait "$lint_pid" || fail=1
cat "$lint_log"
echo "$rest"
case "$rest" in *"FAILED: "*) fail=1 ;; esac

if [ "$fail" -ne 0 ]; then
    echo "check_static(torch): FAILED"
    exit 1
fi
echo "check_static(torch): OK"
