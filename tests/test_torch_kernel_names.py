"""Every CUDA kernel of the port is attributed to its family in the step
profiles, an edited header rebuilds the libraries that include it, and
every raise of a kernel's shared-memory limit goes through one header.

``chip_smoke.kernel_family`` and ``tools/torch_step_profile.family`` sort
the profiler's device events by kernel name; a kernel they do not know
lands under "other elementwise / reductions" and its time is lost among
PyTorch's own kernels. The profiler names a kernel of the sources'
anonymous namespace as ``void (anonymous namespace)::name<...>(...)``.
"""

import importlib.util
import re
import shutil
from pathlib import Path

import pytest

import chip_smoke
from fedml_tpu_torch.ops import build

ROOT = Path(__file__).resolve().parent.parent

# the family each source's kernels belong to
FAMILY = {
    "batchnorm": "bn kernels (K1/K2)",
    "conv_lanes": "lanes conv kernels (K3/K4)",
    "attention": "attention kernel (K6)",
    "xent": "cross-entropy kernel (K5)",
}

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")


def _kernels():
    out = []
    for src in build.SOURCES:
        names = _GLOBAL.findall((build.CSRC / f"{src}.cu").read_text())
        assert names, f"no __global__ kernel found in {src}.cu"
        out += [(src, name) for name in names]
    return out


def _profile_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_step_profile", ROOT / "tools" / "torch_step_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_source_is_listed_and_has_a_family():
    assert sorted(build.SOURCES) == sorted(FAMILY)
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == sorted(build.SOURCES)


@pytest.mark.parametrize("src,name", _kernels())
def test_kernel_family_files_every_kernel_under_its_k_family(src, name):
    for shown in (name, f"void (anonymous namespace)::{name}<__nv_bfloat16, 8>(int, float*)",
                  f"void (anonymous namespace)::{name}(float const*, int)"):
        assert chip_smoke.kernel_family(shown) == FAMILY[src], shown


@pytest.mark.parametrize("src,name", [k for k in _kernels() if k[0] == "batchnorm"])
def test_step_profile_tool_attributes_every_bn_kernel(src, name):
    tool = _profile_tool()
    assert tool.family(f"void (anonymous namespace)::{name}<float, 4>(float const*)") \
        == "bn kernels (K1/K2)"


def test_library_path_changes_with_a_header(monkeypatch, tmp_path):
    """Sources include csrc/*.cuh; a cached library built against an older
    header must not be loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "the sources share a header (grid_barrier.cuh)"
    before = {src: build.library_path(src) for src in build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {src: build.library_path(src) for src in build.SOURCES}
    assert all(before[src] != after[src] for src in build.SOURCES)


def test_shared_memory_limits_go_through_the_header():
    """``cudaFuncSetAttribute`` sets a kernel's dynamic shared-memory limit
    on the current device only, so no source remembers a raised limit in a
    static (a second card would launch above its own 48 KB default): every
    raise is ``raise_smem_limit`` of ``csrc/smem_limit.cuh``, which reads
    the current device's limit back, and each source that raises includes
    that header."""
    header = (build.CSRC / "smem_limit.cuh").read_text()
    assert "cudaFuncGetAttributes" in header and "cudaFuncAttributeMaxDynamicSharedMemorySize" in header
    local_static = re.compile(r"^[ \t]+static\s+(?!constexpr\b)", re.M)
    raisers = []
    for src in build.SOURCES:
        text = (build.CSRC / f"{src}.cu").read_text()
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" not in text, src
        assert "cudaFuncSetAttribute" not in text, src
        assert not local_static.search(text), f"{src}.cu keeps a function-static variable"
        if "raise_smem_limit(" in text:
            assert '#include "smem_limit.cuh"' in text, src
            raisers.append(src)
    assert sorted(raisers) == ["attention", "batchnorm", "conv_lanes"]
