"""Model export and execution-graph capture.

The port of ``dlrm_yx_tpu/export.py``, with what PyTorch offers in place of
JAX's artifacts:

  * **Model export** (``--save-onnx``; the reference exports ONNX,
    ``dlrm_s_pytorch.py:2137-2248``). The JAX package serializes the jitted
    inference forward as StableHLO with ``jax.export``; the port saves a
    ``torch.export`` program of the same forward with ``torch.export.save``
    (``.pt2``). The parameters are inputs of the program, as in JAX, so the
    file holds no weights. With ``--interaction-impl pallas`` the program
    calls the fused interaction's custom operator
    (``dlrm_yx_tpu_torch::fused_interaction``), which runs the CUDA kernel
    on the card: import this package (``load_exported`` does) before
    loading such a program.

  * **Execution-graph capture** (``--collect-execution-graph`` /
    ``--plot-compute-graph``; the reference records one iteration with
    ``ExecutionGraphObserver``, ``dlrm_s_pytorch.py:1810-1814``). The JAX
    package writes the jaxpr, the StableHLO and the optimized HLO of the
    step; the port runs one eager call of the step under
    ``torch.profiler.ExecutionTraceObserver`` (the observer's current name)
    and writes its execution trace, and the profiler's table of the
    operators and kernels that ran.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch

from dlrm_yx_tpu_torch.config import DLRMConfig, refuse_dcn_and_bags
from dlrm_yx_tpu_torch.models.dlrm import forward, model_groups
from dlrm_yx_tpu_torch.utils.profiling import activities


class _InferenceForward(torch.nn.Module):
    """forward(params, dense, indices, weights) -> click probabilities
    [B, 1]: ``models.dlrm.forward`` with the parameters as inputs."""

    def __init__(self, config: DLRMConfig):
        super().__init__()
        self.config = config
        self.groups = model_groups(config)

    def forward(self, params, dense, indices, weights):
        return forward(params, self.config, self.groups, dense, indices, weights)


def export_inference(params, config: DLRMConfig, batch_like, path: str) -> None:
    """Export the inference forward to ``path`` (``torch.export.save``) and
    a sidecar ``path + ".json"`` with the batch shapes and the device type
    (``platforms``, as JAX records its platforms). ``batch_like`` gives the
    shapes of (dense, indices, weights); the program is traced on the
    params' device at those static shapes. DLRM-DCNv2 (``dcn``, multi-hot
    bags) raises ``NotImplementedError``."""
    refuse_dcn_and_bags(config, "export")
    dev = params["emb"][0].device
    dense = torch.zeros(tuple(batch_like.dense.shape), dtype=torch.float32, device=dev)
    indices = torch.zeros(tuple(batch_like.indices.shape), dtype=torch.int32, device=dev)
    weights = torch.zeros(tuple(batch_like.weights.shape), dtype=torch.float32, device=dev)
    with torch.no_grad():
        exported = torch.export.export(_InferenceForward(config),
                                       (params, dense, indices, weights))
    # the example inputs hold the parameters: the saved program keeps none
    exported.example_inputs = None
    torch.export.save(exported, path)
    with open(path + ".json", "w") as f:
        json.dump({"dense": list(dense.shape), "indices": list(indices.shape),
                   "weights": list(weights.shape), "platforms": [dev.type]}, f)


def load_exported(path: str) -> torch.export.ExportedProgram:
    """Reload an exported model; call it with
    ``load_exported(path).module()(params, dense, indices, weights)``."""
    return torch.export.load(path)


def collect_execution_graph(fn, args, out_dir: str, name: str = "train_step") -> Dict[str, str]:
    """Run ``fn(*args)`` once, eagerly, and write what ran:
      {name}.et.json       the execution trace (operators, their inputs and
                           outputs, the phase ranges), from
                           ``ExecutionTraceObserver``
      {name}.kernels.txt   the profiler's table of operators and kernels
    Returns {artifact: path}. A step that updates its arguments in place
    updates them: pass copies to keep the originals."""
    from torch.profiler import ExecutionTraceObserver, profile

    os.makedirs(out_dir, exist_ok=True)
    et_path = os.path.join(out_dir, f"{name}.et.json")
    table_path = os.path.join(out_dir, f"{name}.kernels.txt")
    observer = ExecutionTraceObserver().register_callback(et_path)
    try:
        with profile(activities=activities(), execution_trace_observer=observer) as prof:
            fn(*args)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        observer.unregister_callback()
    sort_by = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(table_path, "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=200))
    return {"execution_trace": et_path, "kernels": table_path}
