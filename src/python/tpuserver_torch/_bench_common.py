"""What the model benchmarks of the port share: the one config, weight
tree and device a run's models serve, the device's name for a row's
note, and where the rows go without ``--out``."""

import dataclasses
import os

import torch

from tpuserver_torch import resolve_device
from tpuserver_torch.models import llama
from tpuserver_torch.models.tree import tree_cast

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def default_out(tool):
    """``build/<tool>.json``: the ignored build directory."""
    return os.path.join(REPO, "build", tool + ".json")


@dataclasses.dataclass
class Serving:
    """The one config, weight tree and device every scheduler and model
    of a run serves."""
    cfg: object
    params: dict
    device: torch.device

    def cast(self, dtype):
        """This serving in ``dtype`` (itself when it already is)."""
        if self.cfg.dtype == dtype:
            return self
        return Serving(dataclasses.replace(self.cfg, dtype=dtype),
                       tree_cast(self.params, dtype), self.device)


def serving(config="tiny", device=None, params=None, vocab=512, dtype=None,
            attn=None):
    """The run's :class:`Serving`: ``config`` (``tiny`` at ``vocab``)
    with ``attn_impl`` ``attn`` (None: the config's), at the dtype and
    depth of ``params``, or drawn from seed 0 in ``dtype`` (None: the
    config's)."""
    dev = resolve_device(device)
    cfg = (llama.tiny(vocab=vocab) if config == "tiny"
           else llama.PRESETS[config]())
    if attn is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn)
    if params is None:
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = llama.init_params(cfg, gen, dev)
    else:
        cfg = dataclasses.replace(cfg, dtype=params["norm"].dtype,
                                  n_layers=len(params["layers"]))
    return Serving(cfg, params, dev)


def device_name(device):
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
