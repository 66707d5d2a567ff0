"""The kernel build runtime (``paddle_tpu_torch.kernels._build``) on the CPU,
with a stand-in ``nvcc``: a failed build raises with the compiler's
output, every kernel source gets its own compiler process, and a built
library is reused instead of rebuilt."""
import stat

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
