"""The kernel library's name follows its sources and the headers they include.

``ops/build.library_path`` names the built library by a hash over the nvcc
flags and every source and header in ``csrc``; a changed header must name a
new library, or a stale one built from the old header would be loaded.
Runs on the CPU: nothing is compiled.
"""

import re
import shutil

from tensorflow_end2end_speech_recognition_tpu_torch.ops import build


def test_library_path_changes_with_a_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    first = build.library_path(csrc)
    assert first == build.library_path(build.CSRC)  # the copy names the same library
    (csrc / "notes.txt").write_text("not a source")
    assert build.library_path(csrc) == first
    header = csrc / "lstm_step.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = build.library_path(csrc)
    assert second != first and second.parent == build.BUILD_DIR
    (csrc / "extra.h").write_text("#pragma once\n")
    assert build.library_path(csrc) != second


def test_every_included_header_is_in_csrc():
    for src in build.CSRC.glob("*.cu"):
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (build.CSRC / name).is_file(), (src.name, name)


def test_signatures_declare_every_c_entry():
    """``build.SIGNATURES``, the ctypes table, declares every kernel entry that
    the sources' ``extern "C"`` blocks define (only the error-string helper is
    declared apart), and each bf16 instantiation takes its float32 entry's
    arguments: #1-#4's bf16 streams, #7's bf16 encoder rows and #3's carried
    walk with bf16 products."""
    from test_torch_lstm_bwd_plan import _extern_c_functions

    defined = _extern_c_functions()
    assert set(defined) - set(build.SIGNATURES) == {"asr_cuda_error_string"}
    bf16 = {name for name in defined if name.endswith("_bf16")}
    assert bf16 == {"lstm_bidi_fwd_bf16", "lstm_bidi_bwd_bf16", "lstm_layer_fwd_bf16",
                    "lstm_layer_bwd_bf16", "location_attend_bf16", "lstm_layer_fwd_carry_bf16"}
    for name in bf16:
        assert defined[name] == defined[name[:-len("_bf16")]], name
        assert build.SIGNATURES[name] == build.SIGNATURES[name[:-len("_bf16")]], name
