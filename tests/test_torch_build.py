"""The port's ctypes binding against its CUDA sources, on the CPU.

The kernels are compiled only on a machine with ``nvcc``, and their C
entry points are loaded through ``ctypes`` with the argument types of
``ops/cuda/_build.ENTRY_POINTS``. A pointer or stream passed without
``c_void_p`` is cut to 32 bits, and an argument count that drifts from the
C declaration shifts every later argument; neither shows until the card
runs. So every ``extern "C"`` declaration in ``csrc/*.cu`` is parsed here
and held against the table. Also: the build targets ``sm_90a`` (``wgmma``
exists only there), hashes every header the sources include, and writes
into a directory that ``.gitignore`` lists.
"""

import ctypes
import re

import pytest

from scalable_hw_agnostic_inference_tpu_torch.ops.cuda import _build

REPO = _build.PACKAGE_ROOT.parent
DECL = re.compile(r'extern\s+"C"\s+([\w\s]+?\**)\s*(\w+)\s*\(([^)]*)\)')


def _declarations():
    out = {}
    for src in _build.sources():
        for ret, name, args in DECL.findall(src.read_text()):
            params = [a.strip() for a in args.split(",") if a.strip()]
            out[name] = (" ".join(ret.split()), params)
    return out


def _ctype(param: str):
    """The ctypes type a C parameter declaration needs."""
    if "*" in param:
        return ctypes.c_void_p
    words = [w for w in param.split() if w != "const"]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[words[0]]


def test_entry_points_are_the_c_functions_that_return_an_error():
    decls = _declarations()
    launching = {n for n, (ret, _) in decls.items() if ret == "int"}
    assert launching == set(_build.ENTRY_POINTS)
    assert decls["shai_cuda_error_string"] == ("const char*", ["int err"])


@pytest.mark.parametrize("name", sorted(_build.ENTRY_POINTS))
def test_entry_point_argtypes_match_the_declaration(name):
    ret, params = _declarations()[name]
    argtypes = _build.ENTRY_POINTS[name]
    assert ret == "int"
    assert len(argtypes) == len(params), params
    for param, got in zip(params, argtypes):
        assert got is _ctype(param), f"{name}: {param!r} bound as {got}"
    # every kernel launches on the caller's stream, passed last as a pointer
    assert params[-1].endswith("stream") and argtypes[-1] is ctypes.c_void_p


def test_build_targets_sm90a_only():
    assert _build.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]
    assert all(f in _build.COMPILE_FLAGS for f in _build.ARCH_FLAGS)


def test_build_key_covers_every_included_header():
    """An edit to a header a source includes must rebuild the library:
    the key hashes ``csrc/*.cu*``, so every local include lives there."""
    hashed = {p.name for p in _build.CSRC.glob("*.cu*")}
    for src in _build.CSRC.glob("*.cu*"):
        for inc in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert inc in hashed, f"{src.name} includes {inc}"


def test_gitignore_lists_the_build_directory():
    rel = _build.BUILD_ROOT.relative_to(REPO).as_posix() + "/"
    lines = (REPO / ".gitignore").read_text().splitlines()
    assert rel in [ln.strip() for ln in lines]
