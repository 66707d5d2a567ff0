"""The kernel build runtime (``paddle_tpu_torch.kernels._build``) on the CPU,
with a stand-in ``nvcc``: a failed build raises with the compiler's
output, every kernel source gets its own compiler process, and a built
library is reused instead of rebuilt. Also the markers by which
``chip_sweeps.py`` varies the kernel sources."""
import importlib.util
import re
import stat
from pathlib import Path

import pytest

from paddle_tpu_torch.kernels import _build

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
    for name, line in zip(_build.KERNELS, calls):
        assert f"csrc/{name}.cu" in line
        assert "arch=compute_90a,code=sm_90a" in line
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
    assert _build.launch_counts()["grouped_matmul"] == 3
    assert _build.variant_counts() == {"grouped_matmul/wgmma": 2,
                                       "grouped_matmul/mma": 1}
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
    assert "kv_write" in _build.KERNELS
    assert {"kv_write", "paged_attention_ref"} <= set(_build.LAUNCHES)
    assert (_build.CSRC_DIR / "kv_write.cu").exists()


def _chip_sweeps():
    path = Path(__file__).resolve().parent.parent / "chip_sweeps.py"
    spec = importlib.util.spec_from_file_location("chip_sweeps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("sweep", ["flash_chunk", "flash_stages",
                                   "flash_bwd_stages", "flash_bwd_tile",
                                   "gmm_tile", "gmm_epilogue",
                                   "gmm_int8_stages", "paged_cluster"])
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


def test_a_missing_sweep_marker_is_an_error():
    sweeps = _chip_sweeps()
    with pytest.raises(ValueError, match="on 0 lines"):
        sweeps.apply_variant("int x = 1;\n", {"absent": "2"})
    with pytest.raises(ValueError, match="on 2 lines"):
        sweeps.apply_variant("int x = 1;  // sweep: a\nint y = 1;  // sweep: a"
                             "\n", {"a": "2"})
