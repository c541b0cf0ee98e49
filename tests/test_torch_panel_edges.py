"""The panel plain versions against the Pallas panel kernels (interpret
mode) at the edges of the layout: tile 8 (pw 16 sub-tiles a panel, 64
threads a tile on the card) and a saturating stack that ends every
walk early (tests/test_rasterizer.py:423). The checks are
test_torch_panel.py's: the forward at TOL, the backward at every slot
the un-sort glue reads.
"""
import pytest

from test_torch_panel import check_against_pallas


@pytest.mark.parametrize("case", ["tile8", "saturating"])
def test_panel_plain_versions_match_pallas_interpret_edges(case):
    check_against_pallas(case)
