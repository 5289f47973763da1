"""PyTorch port: profiling (utils/profiling.py, train.py's --profile;
nsfnet_tpu/utils/profiling.py and nsfnet_tpu/train.py:67-69, 430-438 in the
JAX package): the first stage's torch.profiler trace is written, holds the
step's operations, and leaves the run's results as they are without it."""

import glob
import json

import torch

from nsfnet_tpu_torch import train as port_train
from nsfnet_tpu_torch.training.checkpoint import load_metadata
from nsfnet_tpu_torch.utils.profiling import torch_trace, wallclock

torch.set_num_threads(2)

CONFIG = """\
experiment_name: prof
model_variant: ev-nsfnet
physics: {{Re: 100, alpha_evm: 0.03}}
network: {{layers: 2, layers_1: 2, hidden_size: 8, hidden_size_1: 8}}
training:
  N_f: 64
  seed: 2
  log_interval: 3
  enable_tensorboard: false
  sort_training_points: false
  checkpoint_freq: 1000000
  checkpoint_dir: {out}
  training_stages:
    - {{alpha: 0.03, epochs: 3, lr: 1.0e-3, name: S1}}
    - {{alpha: 0.02, epochs: 2, lr: 1.0e-4, name: S2}}
"""


def test_profile_traces_the_first_stage(tmp_path):
    finals = {}
    for name, extra in (("plain", []), ("traced", ["--profile", str(tmp_path / "trace")])):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(CONFIG.format(out=tmp_path / name))
        assert port_train.main(["--config", str(cfg), "--cpu", *extra]) == 0
        finals[name] = glob.glob(str(tmp_path / name / "**" / "model_final.ckpt"),
                                 recursive=True)[0]
    traces = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert len(traces) == 1  # the first stage only
    events = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert any(n.startswith("aten::") for n in events if n)
    a, b = (torch.load(f, weights_only=True) for f in (finals["plain"], finals["traced"]))
    assert torch.equal(a["params"], b["params"])
    assert load_metadata(finals["traced"])["global_step"] == 5


def test_torch_trace_and_wallclock(tmp_path):
    said = []
    with wallclock("block", sink=said.append), torch_trace(str(tmp_path), cuda=False):
        torch.ones(4) @ torch.ones(4)
    assert len(said) == 1 and said[0].startswith("[block] ")
    assert glob.glob(str(tmp_path / "trace_*.json"))
