#!/usr/bin/env bash
# Distribution smoke test (the analog of the reference's
# tests/test-dist.bash): build a wheel offline and check that both
# packages — the framework and the drop-in compat facade — plus the
# native decoder source ship inside it, then import from the wheel.
set -euo pipefail
cd "$(dirname "$0")/.."

WHEEL_DIR="$(mktemp -d)"
trap 'rm -rf "$WHEEL_DIR"' EXIT

pip wheel . --no-deps --no-build-isolation -w "$WHEEL_DIR" >/dev/null
WHEEL="$(ls "$WHEEL_DIR"/muscle_synergies_tpu-*.whl)"
echo "built: $WHEEL"

python - "$WHEEL" <<'EOF'
import sys, zipfile
wheel = sys.argv[1]
names = zipfile.ZipFile(wheel).namelist()
required = [
    "muscle_synergies_tpu/__init__.py",
    "muscle_synergies/__init__.py",
    "muscle_synergies/vicon_data/__init__.py",
    "muscle_synergies_tpu/native/vicon_decode.cpp",
    "muscle_synergies_tpu/models/kernels/mu_pallas.py",
]
missing = [r for r in required if r not in names]
assert not missing, f"wheel missing: {missing}"
print(f"wheel contents OK ({len(names)} files)")

# import straight from the wheel (zip import) without installing
sys.path.insert(0, wheel)
import muscle_synergies
import muscle_synergies_tpu
assert set(muscle_synergies.__all__) >= {"load_vicon_file", "find_synergies"}
print("imports from wheel OK:",
      muscle_synergies_tpu.__version__, "/", muscle_synergies.__version__)
EOF
echo "dist smoke test passed"
