"""The inputs made from a seed: bitwise those the cells have always had, and
shaped by the configuration's formulation and EVM net."""

import copy
import hashlib

import pytest

from benchmark import run
from benchmark.inputs import make_inputs

# SHA-256 over every tensor of make_inputs at the configuration's own N_f on
# the CPU, in field order, each pair W, b in layer order; taken before the
# head width and the EVM net followed the configuration
FROZEN = {
    ("ev-nsfnet-re2000-6x80", 2147483659):
        "966e8a9c5933c91c3bfa3a2253bd94f0874571f0b0c87a449521760508284590",
    ("ev-nsfnet-re2000-6x80", 3300000001):
        "da860a1f5b0ba8821bfb5f7412a1182338001761224438c53e870f641934f8a9",
    ("ev-nsfnet-re4000-6x160", 2147483659):
        "681352c69a936bed92033f084dce3e217627050bb3fc8081a9e7a3776131ec26",
    ("ev-nsfnet-re4000-6x160", 3300000001):
        "9e63564b430408be3b012ab606a5dfa3abe6de197651f64cbe085bfcc425d6e4",
}


def digest(inp) -> str:
    h = hashlib.sha256()
    for field in inp._fields:
        v = getattr(inp, field)
        for t in ([t for pair in v for t in pair] if field.startswith("params") else [v]):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", list(FROZEN), ids=lambda v: str(v))
def test_the_cells_inputs_are_bitwise_unchanged(name, seed):
    app = run.load_config(name)["app_config"]
    assert digest(make_inputs(app, seed, "cpu")) == FROZEN[name, seed]


def _app(formulation, variant):
    app = copy.deepcopy(run.load_config("ev-nsfnet-re2000-6x80")["app_config"])
    app["network"]["formulation"] = formulation
    app["model_variant"] = variant
    return app


@pytest.mark.parametrize("formulation,width", [("velocity", 3), ("streamfunction", 2)])
@pytest.mark.parametrize("variant", ["ev-nsfnet", "nsfnet"])
def test_the_head_and_the_evm_net_follow_the_configuration(formulation, width, variant):
    inp = make_inputs(_app(formulation, variant), 2**31 + 41, "cpu", n_f=512)
    assert [tuple(w.shape) for w, _ in inp.params] == \
        [(2, 80)] + [(80, 80)] * 5 + [(80, width)]
    assert tuple(inp.params[-1][1].shape) == (width,)
    if variant == "ev-nsfnet":
        assert [tuple(w.shape) for w, _ in inp.params_evm] == \
            [(2, 40)] + [(40, 40)] * 3 + [(40, 1)]
    else:
        assert inp.params_evm is None
    # the points and the hidden layers are drawn before the head, the EVM
    # net last: every configuration of one seed shares them
    flagship = make_inputs(_app("velocity", "ev-nsfnet"), 2**31 + 41, "cpu", n_f=512)
    assert all(a.equal(b) for a, b in zip(inp[:7], flagship[:7]))
    assert all(a.equal(b) for pa, pb in zip(inp.params[:-1], flagship.params[:-1])
               for a, b in zip(pa, pb))
