"""The kernel build runtime (``paddle_tpu_torch.kernels._build``) on the CPU,
with a stand-in ``nvcc``: a failed build raises with the compiler's
output, every kernel source gets its own compiler process, and a built
library is reused instead of rebuilt. Also the markers by which
``chip_sweeps.py`` varies the kernel sources, and a kernel wrapper given
CUDA tensors it does not take raises instead of taking its plain
version."""
import importlib.util
import re
import stat
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_prefill as ppf

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
{body}
"""


def _fake_cuda(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log, body=body))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return home, log


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_failed_build_raises_with_compiler_output(tmp_path, build_dir,
                                                  monkeypatch):
    home, _ = _fake_cuda(tmp_path, 'echo "error: no sm_90a here"; exit 3')
    monkeypatch.setenv("CUDA_HOME", str(home))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build(["paged_attention"])
    assert not list(build_dir.glob("*.so"))   # nothing half-built kept


def test_each_source_built_once_then_reused(tmp_path, build_dir,
                                            monkeypatch):
    # the stand-in compiler "builds" by creating its -o target
    home, log = _fake_cuda(
        tmp_path,
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done',
    )
    monkeypatch.setenv("CUDA_HOME", str(home))
    _build.build()
    calls = log.read_text().splitlines()
    assert len(calls) == len(_build.KERNELS)
    # the nvcc processes run at once, so they log in any order
    for name in _build.KERNELS:
        assert sum(f"csrc/{name}.cu" in line for line in calls) == 1
    assert all("arch=compute_90a,code=sm_90a" in line for line in calls)
    assert sorted(p.name.split("-")[0] for p in build_dir.glob("*.so")) == \
        sorted(_build.KERNELS)
    _build.build()                               # cached: no new process
    assert len(log.read_text().splitlines()) == len(_build.KERNELS)


def test_missing_nvcc_is_an_error(tmp_path, build_dir, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["flash_attention"])


@pytest.mark.parametrize("name", _build.KERNELS)
def test_editing_a_shared_header_renames_every_library(name, tmp_path,
                                                       monkeypatch):
    # a copy of the real sources: the library a source builds into is
    # named by its headers too, so an edited csrc/*.cuh never loads a
    # stale library
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in _build.CSRC_DIR.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    assert (csrc / "hopper.cuh").exists()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    _, before = _build._target(name)
    assert _build._target(name)[1] == before          # stable
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    _, after = _build._target(name)
    assert after != before and after.name.startswith(f"{name}-")


def test_variant_counts_are_kept_beside_the_function_counts():
    _build.reset_launch_counts()
    _build.count_launch("grouped_matmul", "wgmma")
    _build.count_launch("grouped_matmul", "wgmma")
    _build.count_launch("grouped_matmul", "mma")
    _build.count_launch("flash_attention_bwd_dq")
    # a function counted two ways: its page variant and its design
    _build.count_launch("paged_prefill", "float", "split")
    _build.count_launch("paged_prefill", "int8", "ring")
    assert _build.launch_counts()["grouped_matmul"] == 3
    assert _build.launch_counts()["paged_prefill"] == 2
    assert _build.variant_counts() == {"grouped_matmul/wgmma": 2,
                                       "grouped_matmul/mma": 1,
                                       "paged_prefill/float": 1,
                                       "paged_prefill/split": 1,
                                       "paged_prefill/int8": 1,
                                       "paged_prefill/ring": 1}
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
    assert _build.variant_counts() == {}


def test_replay_counts_what_the_capture_recorded():
    # a captured program launches its kernels without calling their
    # wrappers: record_launches takes the capture's launches out of the
    # counters and keeps them, count_replay adds them per replay
    _build.reset_launch_counts()
    _build.count_launch("paged_attention", "cluster")   # before: kept

    def capture():
        for _ in range(3):
            _build.count_launch("kv_write", "int8")
            _build.count_launch("paged_attention_quant", "cluster")
        _build.count_launch("flash_attention")

    record = _build.record_launches(capture)
    assert record == {"kv_write": 3, "kv_write/int8": 3,
                      "paged_attention_quant": 3,
                      "paged_attention_quant/cluster": 3,
                      "flash_attention": 1}
    assert _build.launch_counts()["kv_write"] == 0       # taken back out
    assert _build.variant_counts() == {"paged_attention/cluster": 1}
    for _ in range(5):
        _build.count_replay(record)
    counts = _build.launch_counts()
    assert counts["kv_write"] == 15 and counts["flash_attention"] == 5
    assert counts["paged_attention"] == 1
    assert _build.variant_counts() == {"paged_attention/cluster": 1,
                                       "kv_write/int8": 15,
                                       "paged_attention_quant/cluster": 15}
    # a capture that raises leaves the counters as they were
    with pytest.raises(RuntimeError, match="capture failed"):
        _build.record_launches(lambda: (
            _build.count_launch("kv_write", "float"),
            (_ for _ in ()).throw(RuntimeError("capture failed"))))
    assert _build.launch_counts()["kv_write"] == 15
    assert "kv_write/float" not in _build.variant_counts()
    _build.reset_launch_counts()


def test_launch_names_cover_the_new_kernel_and_the_plain_choice():
    assert {"kv_write", "paged_prefill"} <= set(_build.KERNELS)
    assert {"kv_write", "paged_attention_ref", "paged_prefill",
            "paged_prefill_ref"} <= set(_build.LAUNCHES)
    assert (_build.CSRC_DIR / "kv_write.cu").exists()
    assert (_build.CSRC_DIR / "paged_prefill.cu").exists()
    # the continuation kernel's designs, as its launches are counted
    assert ppf.DESIGNS == ("split", "ring", "fma")
    src = (_build.CSRC_DIR / "paged_prefill.cu").read_text()
    for kernel in ("paged_prefill_split_kernel", "paged_prefill_tc_kernel",
                   "paged_prefill_fma_kernel"):
        assert f"__global__ void __launch_bounds__" in src and kernel in src


def test_paged_prefill_source_is_built_with_the_others(tmp_path, build_dir,
                                                       monkeypatch):
    # the continuation kernel's source gets its own compiler process in
    # the one parallel build, so `python3 chip_smoke.py` alone builds it
    home, log = _fake_cuda(
        tmp_path,
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done',
    )
    monkeypatch.setenv("CUDA_HOME", str(home))
    _build.build()
    (line,) = [x for x in log.read_text().splitlines()
               if "csrc/paged_prefill.cu" in x]
    assert "arch=compute_90a,code=sm_90a" in line
    assert len(list(build_dir.glob("paged_prefill-*.so"))) == 1


def _chip_sweeps():
    path = Path(__file__).resolve().parent.parent / "chip_sweeps.py"
    spec = importlib.util.spec_from_file_location("chip_sweeps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sweep", ["flash_chunk", "flash_stages",
                                   "flash_bwd_stages", "flash_bwd_tile",
                                   "flash_bwd_tf32",
                                   "gmm_tile", "gmm_epilogue",
                                   "gmm_int8_stages", "paged_cluster",
                                   "prefill_mma", "prefill_slices",
                                   "wgrad_tile"])
def test_every_sweep_marker_marks_one_line_of_its_source(sweep):
    # chip_sweeps.py sets the value of each `// sweep: <key>` line in a
    # copy of the sources; an edit that drops or repeats a marker fails
    # here, not on the card
    sweeps = _chip_sweeps()
    source, variants = sweeps.SWEEPS[sweep]
    text = (_build.CSRC_DIR / f"{source}.cu").read_text()
    assert list(variants.values())[0] == {}            # as built first
    for values in variants.values():
        edited = sweeps.apply_variant(text, values)
        assert (edited != text) == bool(values)
        for key, value in values.items():
            (line,) = [x for x in edited.splitlines()
                       if re.search(rf"//\s*sweep:\s*{key}\b", x)]
            assert f"= {value};" in line


def test_the_prefill_split_sweep_finds_its_cluster_cap():
    # prefill_split builds one copy with clusters up to 8 blocks: its
    # marker marks the cap in the continuation kernel's source once
    sweeps = _chip_sweeps()
    text = (_build.CSRC_DIR / "paged_prefill.cu").read_text()
    edited = sweeps.apply_variant(text, {"prefill_max_splits": "8"})
    (line,) = [x for x in edited.splitlines() if "prefill_max_splits" in x]
    assert "kMaxSplits = 8;" in line
    assert max(sp for sp, _ in sweeps.PREFILL_SPLIT_GEOMETRIES) == 8


def test_a_missing_sweep_marker_is_an_error():
    sweeps = _chip_sweeps()
    with pytest.raises(ValueError, match="on 0 lines"):
        sweeps.apply_variant("int x = 1;\n", {"absent": "2"})
    with pytest.raises(ValueError, match="on 2 lines"):
        sweeps.apply_variant("int x = 1;  // sweep: a\nint y = 1;  // sweep: a"
                             "\n", {"a": "2"})


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: takes the wrapper down its
    kernel path on a host with no card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_paged_prefill_on_cuda_raises_rather_than_falls_back(monkeypatch):
    def no_launch():
        raise AssertionError("the kernel was about to launch")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ppf, "_kernel", no_launch)
    monkeypatch.setattr(ppf, "paged_prefill_ref", no_plain)

    def cuda(t):
        return t.as_subclass(_OnCuda)

    pages = cuda(torch.zeros(2, 5, 4, 16))
    table = cuda(torch.zeros(4, dtype=torch.int32))
    scalar = cuda(torch.zeros((), dtype=torch.int32))
    _build.reset_launch_counts()
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        ppf.paged_prefill(cuda(torch.zeros(8, 4, 16, dtype=torch.float64)),
                          pages, pages, table, scalar, scalar)
    with pytest.raises(TypeError, match="pages of q's dtype"):
        ppf.paged_prefill(cuda(torch.zeros(8, 4, 16, dtype=torch.bfloat16)),
                          pages, pages, table, scalar, scalar)
    odd = cuda(torch.zeros(2, 5, 4, 24))
    with pytest.raises(ValueError, match="head_dim 24"):
        ppf.paged_prefill(cuda(torch.zeros(8, 4, 24)), odd, odd, table,
                          scalar, scalar)
    with pytest.raises(ValueError, match="block_table"):
        ppf.paged_prefill(cuda(torch.zeros(8, 4, 16)), pages, pages,
                          torch.zeros(4, dtype=torch.int32), scalar, scalar)
    assert _build.launch_counts()["paged_prefill"] == 0


def test_paged_prefill_abi_matches_the_c_signature(monkeypatch):
    # the ctypes argument types the wrapper declares follow the C launch
    # function's parameters one for one (pointers, ints, the float scale),
    # the slot count first among the ints and the split design's design,
    # rows and splits last before the stream; the same for the split
    # design's occupancy query
    import ctypes
    from types import SimpleNamespace

    src = (_build.CSRC_DIR / "paged_prefill.cu").read_text()

    def c_params(fn):
        (sig,) = re.findall(rf"int {fn}\(([^)]*)\)", src)
        params = [" ".join(p.split()) for p in sig.split(",")]
        types = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if p.startswith("float") else ctypes.c_int
                 for p in params]
        return [p.split()[-1].lstrip("*") for p in params], types

    names, want = c_params("paged_prefill_launch")
    assert names[9:12] == ["slots", "s", "heads"]
    assert names[-7:] == ["dtype", "quant", "design", "rows", "splits",
                          "stages", "stream"]
    occ_names, occ_want = c_params("paged_prefill_split_occupancy")
    assert occ_names == ["d", "dtype", "quant", "rows", "stages",
                         "pages_per_seq", "splits"]
    lib = SimpleNamespace(paged_prefill_launch=SimpleNamespace(),
                          paged_prefill_split_occupancy=SimpleNamespace())
    monkeypatch.setattr(ppf, "_lib", None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    assert ppf._kernel() is lib
    assert lib.paged_prefill_launch.argtypes == want
    assert lib.paged_prefill_launch.restype is ctypes.c_int
    assert lib.paged_prefill_split_occupancy.argtypes == occ_want
    assert lib.paged_prefill_split_occupancy.restype is ctypes.c_int
    # the design ids the wrapper passes are the ones the source reads
    assert "design == 1" in src and ppf._DESIGN_IDS["split"] == 1
    assert ppf._DESIGN_IDS["ring"] == ppf._DESIGN_IDS["fma"] == 0
