"""`kernel_probe.py` patches copies of `csrc/` to take a kernel apart (no
products, no copies, no epilogue, ...). Each patch replaces one piece of
text; a redesign that moves that text would leave the probe patching
nothing, or, where the text occurs twice, something else. So every patch
anchor in its tables occurs exactly once in the `csrc/` file it names, as
`start_build` requires on the card."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import kernel_probe  # noqa: E402

CSRC = ROOT / "uplift_upsample_torch" / "csrc"
TABLES = ("ATTENTION", "GEMM", "BF16_DENSE", "BF16_GEMM", "DW", "DW_BF16", "DWC", "CONV", "DH1",
          "ATTN_BWD", "ATTN_BF16IO", "K4", "K1", "SHORT")


@pytest.mark.parametrize("table", TABLES)
def test_every_patch_anchor_occurs_once(table):
    variants = getattr(kernel_probe, table)
    assert variants["kernel"] == []  # the kernel as it is, unpatched
    for name, reps in variants.items():
        for fname, old, new in reps:
            count = (CSRC / fname).read_text().count(old)
            assert count == 1, (table, name, fname, old, count)
            assert new != old, (table, name)


def test_every_table_is_built():
    """Every table the probe builds is checked above (a new table joins TABLES)."""
    names = {name for name, value in vars(kernel_probe).items()
             if name.isupper() and isinstance(value, dict) and "kernel" in value}
    assert names == set(TABLES) | {"K1_AB"}  # K1 holds K1_AB's variants
    assert kernel_probe.K1_AB.items() <= kernel_probe.K1.items()
