#!/bin/bash
# Build the reference renderer headless with -DDOF and render bunny20
# (aperture 0.20, focus plane 15.3 — Miro.h:18-19; thin-lens eye-ray
# jitter Camera.cpp:135-148). Lens samples are frand-stochastic, so the
# output is a STATISTICAL baseline: a parity check compares 8x8
# block means (64 independent lens samples per block) with an MC-scaled
# tolerance, like the pt_cornell and photon_cornell cases.
#
# Usage: bash tools/golden_harness/build_dof.sh [scratch-dir]
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
REF=${REF:-/root/reference}
B=${1:-/tmp/refbuild_dof}
mkdir -p "$B/GL" "$B/lib/include" "$B/lib/src"
cp "$REF"/*.cpp "$REF"/*.h "$B"/
cp -r "$REF"/lib/include/* "$B"/lib/include/
cp "$REF"/lib/src/*.cpp "$B"/lib/src/
cp "$HERE/fake_glut.h" "$B/GL/glut.h"
cp "$HERE/freeimage_stubs.cpp" "$B/"
sed -i 's/std::min((pow(f1f0,2)-1.f), 0.75f)/std::min((float)(pow(f1f0,2)-1.f), 0.75f)/' "$B/Texture.cpp"
python3 "$HERE/patch_main.py" "$B/main.cpp" || true
cd "$B"
g++ -O3 -std=gnu++14 -DNO_GFX -DOPENMP -DDOF -fopenmp -msse4.1 -w \
    -I. -Ilib/include -Ilib/include/noise \
    *.cpp lib/src/*.cpp -o miro_dof -lm
ln -sfn "$REF/models" models
./miro_dof bunny20 > dof_bunny20.log 2>&1
mv bunny20.ppm dof_bunny20.ppm
echo "dof_bunny20: $(grep -o 'Time spent raytracing image: [0-9.]*' dof_bunny20.log)"
echo "golden PPM in $B/dof_bunny20.ppm — copy to tests/golden/dof_bunny20.ppm"
