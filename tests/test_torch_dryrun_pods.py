"""The dry run on a fake ``(2, 2, 2)`` world (``("pod", "data",
"model")``, the multi-pod mesh's axes): ``trace_cell`` on one smoke
config of every family for every kind ``cells_for`` lists, at the small
shapes of ``test_torch_dryrun.py``. Every row is ``ok`` and moves bytes
over the collectives; each test makes its own fake process group and
destroys it, pass or fail."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import FAMILIES, check_rows, trace_family  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_trace_cell_on_a_2x2x2_world(arch):
    check_rows(arch, trace_family(arch, (2, 2, 2)), (2, 2, 2))
