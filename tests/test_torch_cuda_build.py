"""utils/cuda_build names a library by the hash of its source AND of every
csrc/ header the source includes (no nvcc needed to check that)."""
import pytest

from svscope_tpu_torch.utils import cuda_build


def write(d, name, text):
    (d / name).write_text(text)


def test_digest_follows_includes(tmp_path):
    write(tmp_path, "k.cu", '#include <cstdint>\n#include "a.cuh"\n'
          'int k() { return A; }\n')
    write(tmp_path, "a.cuh", '#pragma once\n  #  include "b.cuh"\n'
          '#define A B\n')
    write(tmp_path, "b.cuh", "#define B 1\n")
    write(tmp_path, "other.cuh", "#define C 2\n")
    d = str(tmp_path)
    assert cuda_build.source_files("k.cu", d) == ["k.cu", "a.cuh", "b.cuh"]
    h0 = cuda_build.source_digest("k.cu", d)
    write(tmp_path, "b.cuh", "#define B 2\n")        # nested header edit
    h1 = cuda_build.source_digest("k.cu", d)
    assert h1 != h0
    write(tmp_path, "other.cuh", "#define C 3\n")    # not included
    assert cuda_build.source_digest("k.cu", d) == h1
    write(tmp_path, "k.cu", '#include "a.cuh"\nint k() { return A + 0; }\n')
    assert cuda_build.source_digest("k.cu", d) != h1


def test_include_cycle_and_missing_source(tmp_path):
    write(tmp_path, "x.cuh", '#include "y.cuh"\n')
    write(tmp_path, "y.cuh", '#include "x.cuh"\n#include "gone.cuh"\n')
    write(tmp_path, "k.cu", '#include "x.cuh"\n')
    assert cuda_build.source_files("k.cu", str(tmp_path)) == \
        ["k.cu", "x.cuh", "y.cuh"]
    with pytest.raises(FileNotFoundError):
        cuda_build.source_files("missing.cu", str(tmp_path))


def test_repo_kernels_share_the_dp_header():
    for src in ("poa_align.cu", "poa_pk_align.cu"):
        assert cuda_build.source_files(src) == [src, "poa_row.cuh",
                                                "poa_dp.cuh"]
    assert cuda_build.source_files("probe_row.cu") == \
        ["probe_row.cu", "poa_dp.cuh", "poa_row.cuh"]
    assert cuda_build.source_files("poa_pk_fusion.cu") == \
        ["poa_pk_fusion.cu"]


def test_build_key_names_each_macro_set():
    """A build with -D macros (tools/k1_split's stamped K1) is a library
    and a BUILD_LOG entry of its own."""
    assert cuda_build.build_key("poa_align.cu") == "poa_align.cu"
    assert cuda_build.build_key("poa_align.cu", ("POA_ALIGN_SPLIT",)) == \
        "poa_align.cu -DPOA_ALIGN_SPLIT"
