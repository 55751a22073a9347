"""The port's architecture configs (``repro_torch.configs``) against the
reference's, field for field, full and smoke size: every field the port
keeps equals the reference's, any field it left out would have to be at the
reference's default (none is left out), the analytic
parameter counts agree, and the port registers every arch the reference
does, in its order."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
pytest.importorskip("jax")

from repro.models import config as JC  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402


def _same(t, j):
    tf = {f.name for f in dataclasses.fields(t)}
    for f in dataclasses.fields(j):
        want = getattr(j, f.name)
        if f.name in tf:
            assert getattr(t, f.name) == want, f.name
        else:
            assert want == f.default, f"{f.name} = {want!r} is not served by the port"
    assert tf <= {f.name for f in dataclasses.fields(JC.ModelConfig)}


@pytest.mark.parametrize("arch", TR.ARCHS)
def test_config_matches_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        t, j = getattr(TR, get)(arch), getattr(JR, get)(arch)
        _same(t, j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
    assert TR.ARCHS == JR.ARCHS
