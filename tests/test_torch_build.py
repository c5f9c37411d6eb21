"""The kernel libraries' names (``kernels/build.py``): a hash of each
source and of the ``csrc/`` headers it includes, so that an edited header
rebuilds the libraries that use it and no other. Runs without nvcc."""

import shutil

from repro_torch.kernels import build


def test_sources_include_the_shared_header_where_they_use_it():
    users = {n for n in build.sources()
             if build._local_headers((build.CSRC / f"{n}.cu").read_bytes())}
    assert users == {"flash_attention", "flash_attention_bwd_tc"}
    for n in users:
        src = (build.CSRC / f"{n}.cu").read_bytes()
        assert build._local_headers(src) == ["wgmma_bf16.cuh"]


def test_an_edited_header_renames_only_its_users(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._lib_path(n).name for n in build.sources()}
    header = csrc / "wgmma_bf16.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._lib_path(n).name for n in build.sources()}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == {"flash_attention", "flash_attention_bwd_tc"}


def test_headers_are_followed_into_headers_once(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "a.cuh").write_bytes(b'#include "b.cuh"\n#include <cuda.h>\n')
    (tmp_path / "b.cuh").write_bytes(b'#include "a.cuh"\n')
    src = b'#include "a.cuh"\n  #  include "b.cuh"\n#include "missing.h"\n'
    assert build._local_headers(src) == ["a.cuh", "b.cuh"]
