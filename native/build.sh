#!/bin/sh
# Quick build without cmake (CI / dev convenience); cmake build also works:
#   cmake -S native -B native/build -G Ninja && ninja -C native/build
# Optional argument: output path (default lib/libtpusfm_ingest.so).
set -e
out="$(realpath -m "${1:-$(dirname "$0")/lib/libtpusfm_ingest.so}")"
cd "$(dirname "$0")"
mkdir -p "$(dirname "$out")"
g++ -std=c++20 -O3 -shared -fPIC src/ingest.cpp -o "$out" \
    -ljpeg -lpng -lz -pthread
echo "built $out"
