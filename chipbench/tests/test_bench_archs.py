"""The qwen2 architecture module gives what the harness gave before its
pieces moved there: the same leaves (paths, shapes, dtypes, scales and
shifts, in the same order), the same operation counts (and a flash
call's operations and bytes, as the flash reader took them) at both
configurations' full sizes, and the same reference gaps, bit for bit, on
the tiny models.  The readings are in qwen2_pins.json, taken from the
harness before the move."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chipbench import check, spec, weights
from chipbench.tests import tiny

PINS = json.loads((Path(__file__).parent / "qwen2_pins.json").read_text())
CONFIGS = ["qwen2-7b", "qwen2-moe-a2.7b"]


def _config(name):
    return spec.load_config(spec.load_benchmark(), name)


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_the_parents(name):
    config = _config(name)
    assert config["arch"] == "qwen2"
    got = [[p, list(s), str(d), sc, sh] for p, s, d, sc, sh
           in spec.arch(config["arch"]).leaf_specs(config["model"])]
    assert got == PINS[name]["leaf_specs"]


@pytest.mark.parametrize("name", CONFIGS)
def test_operation_counts_are_the_parents(name):
    config = _config(name)
    arch, m = spec.arch(config["arch"]), config["model"]
    pins = PINS[name]
    assert [arch.matmul_params_per_token(m, True),
            arch.matmul_params_per_token(m, False)] == pins["mpt"]
    assert [[a, b, h, arch.positions_flops(m, a, b, h)]
            for a, b, h, _ in pins["pos"]] == pins["pos"]
    assert {k: list(v) for k, v in arch.projection_shapes(m).items()} \
        == pins["shapes"]
    assert [[n, *arch.flash_call(m, n)] for n, _, _ in pins["flash"]] \
        == pins["flash"]


@pytest.mark.parametrize("key,model", [("dense", tiny.DENSE),
                                       ("moe", tiny.MOE)])
def test_reference_gaps_are_the_parents(key, model):
    """Random tokens judged at every read position, and the control's
    own tokens at INT4: the whole logits row of each position counts."""
    params = weights.make(tiny.ARCH, model, 2 ** 31 + 11, "cpu")
    g = torch.Generator().manual_seed(17)
    seqs = [torch.randint(0, model["vocab"], (n,), generator=g)
            for n in (7, 12)]
    reads = [torch.arange(7), torch.arange(4, 12)]
    chosen = [torch.randint(0, model["vocab"], (len(r),), generator=g)
              for r in reads]
    prog, ctl = check.top_gaps(tiny.ARCH, model, params, seqs, reads,
                               chosen, control_bits=4)
    want = PINS["gaps_" + key]
    for got, pinned in ((prog, want["program"]), (ctl, want["control"])):
        assert len(got) == len(pinned)
        for a, b in zip(got, pinned):
            assert np.array_equal(a, np.asarray(b, np.float32))
