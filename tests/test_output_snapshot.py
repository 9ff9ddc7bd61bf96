"""Output-format regression: the R1_* file set must stay byte-identical for a
fixed simulation seed (guards the many reference-faithful output behaviors
through refactors).  Regenerate intentionally with
`python tests/_golden_gen.py` after a deliberate format change."""

import os

import pytest

from _golden_gen import GOLDEN, SNAPSHOT_FILES, generate


@pytest.mark.skipif(not os.path.isdir(GOLDEN), reason="no golden snapshot")
def test_output_files_byte_stable(tmp_path):
    out = generate(str(tmp_path))
    for rel in SNAPSHOT_FILES:
        got_path = os.path.join(out, rel)
        want_path = os.path.join(GOLDEN, rel.replace("/", "__"))
        with open(got_path) as fh:
            got = fh.read()
        with open(want_path) as fh:
            want = fh.read()
        assert got == want, f"{rel} drifted from golden snapshot"
