"""DistributedStrategy: the strategy config object (counterpart of
paddle_tpu/distributed/fleet/base/distributed_strategy.py): the
reference's field names and defaults, serializable to dict/JSON.

What each strategy does here: amp -> the bf16 (or fp16 with loss
scaling) cast rewrite, recompute -> segment-checkpointed backward,
gradient_merge -> a conditional optimizer sub-block, lamb/lars ->
optimizer swap, dgc -> DGC momentum, fp16_allreduce -> half-precision
gradient all-reduce, localsgd (k_steps 1) -> parameter averaging;
sharding and pipeline wait for ROADMAP queue 1 item 10b."""

from __future__ import annotations

import json


class DistributedStrategy:
    def __init__(self):
        # collective execution
        self.nccl_comm_num = 1  # parity knob: one ring, the data axis
        self.use_hierarchical_allreduce = False
        self.fuse_grad_size_in_MB = 32
        self.fuse_all_reduce_ops = True

        # amp (proto:31)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2,
            "incr_ratio": 2.0,
            "decr_ratio": 0.5,
            "use_dynamic_loss_scaling": True,
            "custom_white_list": [],
            "custom_black_list": [],
            # bf16 needs no loss scaling and is the default
            "dtype": "bfloat16",
        }

        # recompute (proto:25)
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}

        # pipeline (proto:37)
        self.pipeline = False
        self.pipeline_configs = {"micro_batch": 1, "accumulate_steps": 1}

        # localsgd (proto:43,48)
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1}
        self.adaptive_localsgd = False

        # gradient merge (proto:53)
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}

        # dgc (proto:58)
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0}

        # large-batch optimizers (proto:64,71)
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                             "epsilon": 0.0,
                             "exclude_from_weight_decay": []}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}

        # sharding / ZeRO (proto:27)
        self.sharding = False
        self.sharding_configs = {"fuse_broadcast_MB": 32, "stage": 1}

        # fp16 allreduce
        self.fp16_allreduce = False

        # PS-mode flags kept for API parity (no parameter-server mode)
        self.a_sync = False
        self.a_sync_configs = {}

        # misc
        self.elastic = False
        self.auto = False
        self.cudnn_exhaustive_search = False  # parity knob
        self.execution_strategy = None
        self.build_strategy = None

    # -- serialization (proto round-trip parity) ---------------------------
    def to_dict(self) -> dict:
        return {k: v for k, v in self.__dict__.items()
                if not k.startswith("_") and k not in ("execution_strategy",
                                                       "build_strategy")}

    @staticmethod
    def from_dict(d: dict) -> "DistributedStrategy":
        s = DistributedStrategy()
        for k, v in d.items():
            if hasattr(s, k):
                setattr(s, k, v)
        return s

    def save_to_prototxt(self, output: str):
        with open(output, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    def load_from_prototxt(self, pb_file: str):
        with open(pb_file) as f:
            d = json.load(f)
        for k, v in d.items():
            if hasattr(self, k):
                setattr(self, k, v)

    def __repr__(self):
        on = [k for k, v in self.to_dict().items() if v is True]
        return f"DistributedStrategy(enabled={on})"
