#!/usr/bin/env bash
# CI entry point.
#
#   ./ci.sh          fast suite (every commit): full tests/ on the virtual
#                    8-device CPU mesh + the multichip dryrun compile check
#   ./ci.sh nightly  adds the slow scale ladder (TPUSFM_SLOW gated medium/
#                    pod-scale tests) and the native ingest pool under TSAN
#
# On a machine with an NVIDIA GPU, `python chip_smoke.py` runs the whole
# system on the card and `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`
# the GPU-only tests; `python bench.py` measures it.
#
# The reference ships zero tests (SURVEY.md §4); this pyramid is the
# framework's own contract — keep it green.
set -euo pipefail
cd "$(dirname "$0")"

echo "== fast suite =="
python -m pytest tests/ -x -q

echo "== multichip dryrun (8 virtual devices) =="
python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

if [[ "${1:-}" == "nightly" ]]; then
    echo "== slow scale ladder =="
    TPUSFM_SLOW=1 python -m pytest tests/test_medium_scale.py tests/test_pod_scale.py -q
    echo "== native TSAN (ingest worker pool) =="
    mkdir -p native/build_tsan
    g++ -std=c++20 -O1 -g -fsanitize=thread native/src/ingest.cpp \
        native/test/tsan_pool_test.cpp -o native/build_tsan/tsan_pool_test \
        -ljpeg -lpng -lz -pthread
    ./native/build_tsan/tsan_pool_test
fi

echo "CI OK"
