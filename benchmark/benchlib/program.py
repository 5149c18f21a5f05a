"""The harness's handles on the program: its configuration, built from a
configuration file, and the buffers its graphs wrote."""
from __future__ import annotations

from typing import Dict, List

import torch


def program_config(cfg: Dict):
    """The program's ``Config`` of a configuration file."""
    from imfnet_tpu_torch import config as port_config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return getattr(port_config, cfg["program"]["preset"])(
        **{k: tup(v) for k, v in cfg["program"]["overrides"].items()})


class Capture:
    """The model's input table and output at each call, by the table's row
    count: after a capture, the buffers every replay rewrites."""

    def __init__(self, model: torch.nn.Module):
        self.by_rows: Dict[int, Dict[str, torch.Tensor]] = {}
        self.calls: List[Dict[str, torch.Tensor]] = []
        model.register_forward_hook(self._hook)

    def _hook(self, module, inputs, output):
        sv = inputs[0]
        rec = {"coords": sv.coords, "num_valid": sv.num_valid, "feats": output}
        self.by_rows[int(sv.coords.shape[0])] = rec
        self.calls.append(rec)


class NNCapture:
    """The registration's nearest-neighbour calls (``eval.registration
    .nn_auto``: queries, references, the references' validity, and the
    index it returned), as they are made. The recorded tensors are held,
    so after a capture they are the buffers every replay rewrites; the
    call itself is the program's, unchanged."""

    def __init__(self):
        from imfnet_tpu_torch.eval import registration

        self.calls: List[Dict[str, torch.Tensor]] = []
        self._module, self._real = registration, registration.nn_auto
        real = self._real

        def recorded(queries, refs, ref_valid=None):
            idx, d2 = real(queries, refs, ref_valid)
            self.calls.append({"queries": queries, "refs": refs, "ref_valid": ref_valid,
                               "idx": idx})
            return idx, d2

        registration.nn_auto = recorded

    def close(self) -> None:
        """Puts the program's own function back."""
        self._module.nn_auto = self._real
