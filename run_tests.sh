#!/bin/bash
# Run the test suite on a virtual 8-device CPU mesh.
#
# Default lane skips tests marked @slow (target: green in <15 min on an
# 8-core host). `./run_tests.sh --full` runs everything. Any other args
# are passed through to pytest.
cd "$(dirname "$0")"
# build the native host runtime (C++ prefetch loader) so its tests run
if [ ! -f native/build/libhslam_loader.so ] || [ native/loader.cpp -nt native/build/libhslam_loader.so ]; then
    bash native/build.sh || echo "WARNING: native build failed; loader tests will skip"
fi

LANE=(-m "not slow")
if [ "$1" = "--full" ]; then
    LANE=()
    shift
fi

# default to the whole suite only when the caller gave no paths
TARGET=(tests/)
for a in "$@"; do
    case "$a" in
        -*) ;;
        *) TARGET=(); break;;
    esac
done

# tests/conftest.py keeps the persistent compile cache off on the CPU
env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python -m pytest "${TARGET[@]}" "${LANE[@]}" "$@"
exit $?
