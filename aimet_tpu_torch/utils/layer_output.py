"""Per-layer intermediate tensor dump for on-target comparison —
counterpart of ``aimet_tpu/utils/layer_output.py``.

Port of aimet_torch/layer_output_utils.py: saves every (quantized) op
output over given inputs to disk as ``.npy`` files, named by the port
graph's product names (``{op}.out``) with a ``manifest.json`` mapping each
name to its file, so device outputs can be diffed against simulation
bit-for-bit.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..quantsim.qsim import QuantizationSimModel


class LayerOutputUtil:
    def __init__(self, sim: QuantizationSimModel, save_dir: str,
                 mode: str = "quantized"):
        self.sim = sim
        self.save_dir = save_dir
        self.mode = mode
        os.makedirs(save_dir, exist_ok=True)
        self.product_names = [op.output.name for op in sim.graph.ops]

    def generate_layer_outputs(self, params, batch, batch_index: int = 0):
        """Dump every op's output for ``batch`` (a tensor or a tuple of
        model inputs) under ``batch_<batch_index>/``; ``params`` None: the
        sim's model's. Returns the manifest {product name: file}."""
        args = batch if isinstance(batch, (tuple, list)) else (batch,)
        caps = self.sim.collect_activations(
            params, args, self.product_names, mode=self.mode)
        batch_dir = os.path.join(self.save_dir, f"batch_{batch_index}")
        os.makedirs(batch_dir, exist_ok=True)
        manifest = {}
        for name, val in caps.items():
            fname = name.replace("/", "_").replace(".", "_") + ".npy"
            if val.dtype == torch.bfloat16:     # numpy has no bf16
                val = val.float()
            np.save(os.path.join(batch_dir, fname),
                    val.detach().cpu().numpy())
            manifest[name] = fname
        with open(os.path.join(batch_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        return manifest
