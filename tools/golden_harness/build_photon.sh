#!/bin/bash
# Build the reference renderer headless and render the photon-parity
# scene (cornell geometry + DirectionalAreaLight — the only light type
# tracePhotons emits from, Scene.cpp:368,430). The photon map is
# stochastic (frand-driven emission + Russian roulette, OpenMP
# nondeterministic accumulation order), so the output is a STATISTICAL
# baseline: a parity check compares 8x8 block means with an
# MC-scaled tolerance (like the pt_cornell cases).
#
# Usage: bash tools/golden_harness/build_photon.sh [scratch-dir]
set -e
HERE="$(cd "$(dirname "$0")" && pwd)"
REF=${REF:-/root/reference}
B=${1:-/tmp/refbuild_photon}
mkdir -p "$B/GL" "$B/lib/include" "$B/lib/src"
cp "$REF"/*.cpp "$REF"/*.h "$B"/
cp -r "$REF"/lib/include/* "$B"/lib/include/
cp "$REF"/lib/src/*.cpp "$B"/lib/src/
cp "$HERE/fake_glut.h" "$B/GL/glut.h"
cp "$HERE/freeimage_stubs.cpp" "$B/"
sed -i 's/std::min((pow(f1f0,2)-1.f), 0.75f)/std::min((float)(pow(f1f0,2)-1.f), 0.75f)/' "$B/Texture.cpp"
python3 "$HERE/patch_main.py" "$B/main.cpp" || true
cd "$B"
g++ -O3 -std=gnu++14 -DNO_GFX -DOPENMP -fopenmp -msse4.1 -w \
    -I. -Ilib/include -Ilib/include/noise \
    *.cpp lib/src/*.cpp -o miro_photon -lm
ln -sfn "$REF/models" models
./miro_photon photoncornell > photoncornell.log 2>&1
echo "photoncornell: $(grep -o 'Time spent raytracing image: [0-9.]*' photoncornell.log)"
echo "golden PPM in $B/photoncornell.ppm — copy to tests/golden/photon_cornell.ppm"
