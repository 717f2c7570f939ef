"""FedQuant: quantized FedAvg (algorithms/fed_quant.py of the JAX package).

* Local training applies straight-through fake-quant to the params inside
  the loss (QAT, ops/quantize.py ``fake_quant``, per leaf of the flat
  vector).
* Each client's upload is stochastically quantized to ``quant_levels``
  levels and dequantized before the weighted average (a chunk's uploads in
  one pass, row by row); the aggregate is
  quantized the same way for the downlink broadcast. The salts are one per
  (client, leaf) and one per leaf of the broadcast (algorithms/fedavg.py).
* With ``client_stats`` on, the round reports the downlink's mean squared
  quantization error (``quant_mse``).
* post_round reports the analytic compression ratios (ops/payload.py) and,
  with ``client_eval`` (auto-on at cohorts <= 32), each client's QAT model
  evaluated before aggregation.
"""

from __future__ import annotations

import torch

from distributed_learning_simulator_tpu_torch.algorithms.fedavg import FedAvg
from distributed_learning_simulator_tpu_torch.ops.payload import (
    compression_ratio,
    payload_bytes,
    quantized_payload_bytes,
)
from distributed_learning_simulator_tpu_torch.ops.quantize import (
    dequantize,
    fake_quant,
    stochastic_quantize,
)
from distributed_learning_simulator_tpu_torch.parallel.engine import (
    row_slices,
)
from distributed_learning_simulator_tpu_torch.telemetry.client_stats import (
    ClientStats,
)


class FedQuant(FedAvg):
    name = "fed_quant"
    payload_salted = True

    @property
    def levels(self) -> int:
        # 256 levels = 8-bit, the reference's choice.
        return self.config.quant_levels

    def client_param_transform(self):
        if not self.config.qat:
            return None
        levels, segments = self.levels, self.segments
        return lambda flat: fake_quant(flat, levels, segments)

    def _quantize_roundtrip(self, flat, salts):
        q = stochastic_quantize(flat, self.levels, salts, self.segments)
        return dequantize(q, self.segments)

    def process_client_payload(self, client_params, salts):
        """The quantized uplink of a chunk: each row stochastically
        quantized with its own salts, then dequantized (f32), a
        ``row_slices`` slice of the stack at a time (the int64 hash
        temporaries stay bounded)."""
        salts = torch.as_tensor(salts, dtype=torch.int64)
        out = torch.empty(client_params.shape, dtype=torch.float32,
                          device=client_params.device)
        for rows in row_slices(client_params):
            q = stochastic_quantize(client_params[rows], self.levels,
                                    salts[rows], self.segments, rows=True)
            out[rows] = dequantize(q, self.segments)
        return out, {}

    def process_aggregated(self, global_params, salts):
        """The quantized downlink broadcast. With ``client_stats`` on, also
        its mean squared quantization error (``quant_mse``, a device
        scalar for the ``client_stats`` sub-object)."""
        deq = self._quantize_roundtrip(global_params, salts)
        aux = {}
        if ClientStats.from_config(self.config) is not None:
            err = deq.float() - global_params.float()
            aux["quant_mse"] = (err * err).sum() / global_params.numel()
        return deq, aux

    def post_round(self, ctx):
        raw = payload_bytes(ctx.layout)
        comp = quantized_payload_bytes(ctx.layout, self.levels)
        ratio = compression_ratio(raw, comp)
        out = {
            "uplink_compression_ratio": ratio,
            "downlink_compression_ratio": ratio,
            "payload_bytes_raw": raw,
            "payload_bytes_quantized": comp,
        }
        out.update(super().post_round(ctx))  # client_eval
        return out
