"""Inference: export, load and serve models (counterpart of
paddle_tpu/inference, Paddle's AnalysisPredictor and the 2.x
`save_inference_model` / `load_inference_model`).

The artifact is a `torch.export` program, written with
`torch.export.save` as `<prefix>.pt2`, where the JAX package writes
StableHLO, beside a `<prefix>.json` manifest with the reference's keys
(`format` names the torch format).  `save_inference_model(prefix, layer,
input_spec)` traces `layer.forward` in eval mode over the concrete
`input_spec` shapes, as the reference exports over concrete shapes, so
the batch dim is fixed (`_fixed_batch`).  The weights are folded into
the program (its lifted parameters and buffers), or, with
`fold_params=False`, written to `<prefix>.pdiparams` through the port's
framework_io and passed in as the program's first argument.  With a
cipher and key (inference.crypto) the `.pt2` bytes are stored
encrypted.

The hand-written kernels' forward launches are operators
(`paddle_tpu_torch::flash_forward`, `::ffn_forward`, `::ffn_act_fwd`),
so the traced graph records them, not the plain version one device
would take: the Predictor launches the kernels on the card.  A traced
program keeps the device its constants were made on: a Predictor asked
to run it on another device raises and names both (ROADMAP queue 3).

`Predictor.run` is the ZeroCopyRun role: the inputs are padded to the
export's batch through the serving BucketedRunner and the outputs come
back as numpy; `run_handles` returns LazyFetch handles over the device
tensors.  `serving.Engine` / `ModelRegistry` take a Predictor as a
model.
"""

from __future__ import annotations

import io
import json
import os
import warnings

import numpy as np
import torch

from .. import device as _device

FORMAT = "torch.export.pt2"
# Config(device=EXPORTED): run where the program was traced (the C ABI's
# bridge loads models so)
EXPORTED = "exported"
_WARNED: set = set()


def _warn_once(key: str, msg: str) -> None:
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(msg, stacklevel=3)


def _layer_device(layer) -> torch.device:
    for t in list(layer.parameters()) + list(layer.buffers()):
        return t.device
    return torch.device("cpu")


def _example(spec, dev):
    """An example input on `dev` from a (shape, dtype) pair, an array or
    a tensor (its values do not matter to the trace)."""
    if isinstance(spec, tuple) and len(spec) == 2 and isinstance(
            spec[0], (list, tuple)):
        shape, dtype = spec
        from ..fluid import core

        return torch.zeros(tuple(shape), dtype=core.torch_dtype(dtype),
                           device=dev)
    if isinstance(spec, torch.Tensor):
        return spec.detach().to(dev)
    return torch.from_numpy(np.asarray(spec)).to(dev)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


class _Forward(torch.nn.Module):
    """layer(*xs) as a module, its outputs a tuple."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *xs):
        out = self.layer(*xs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


class _FunctionalForward(torch.nn.Module):
    """layer(*xs) with its parameters and buffers passed in as a dict."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, state, *xs):
        out = torch.func.functional_call(self.layer, state, xs)
        return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def save_inference_model(path_prefix, layer, input_spec, fold_params=True,
                         cipher=None, key=None):
    """Export `layer.forward` over `input_spec` (a list of (shape, dtype)
    pairs, arrays or tensors) with torch.export, on the layer's device.
    Writes <prefix>.pt2 and <prefix>.json (and <prefix>.pdiparams with
    fold_params=False); with `cipher` + `key` the .pt2 is encrypted."""
    layer.eval()
    dev = _layer_device(layer)
    xs = tuple(_example(s, dev) for s in input_spec)
    params_path = None
    with torch.no_grad():
        if fold_params:
            ep = torch.export.export(_Forward(layer), xs)
        else:
            if cipher is not None or key is not None:
                raise NotImplementedError(
                    "save_inference_model: encryption with "
                    "fold_params=False would leave the .pdiparams weights "
                    "in PLAINTEXT; fold the params (fold_params=True) so "
                    "the whole model is one encrypted artifact")
            state = {**dict(layer.named_parameters()),
                     **dict(layer.named_buffers())}
            state = {k: v.detach() for k, v in state.items()}
            ep = torch.export.export(_FunctionalForward(layer),
                                     (state,) + xs)
            params_path = path_prefix + ".pdiparams"
            from ..framework_io import save as psave

            psave(state, params_path)
    d = os.path.dirname(path_prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    if key is not None and cipher is None:
        from .crypto import AESCipher

        cipher = AESCipher("CTR")
    if cipher is not None:
        if key is None:
            raise ValueError("save_inference_model: cipher given "
                             "without key")
        blob = cipher.encrypt(bytes(blob), key)
    with open(path_prefix + ".pt2", "wb") as f:
        f.write(blob)
    manifest = {
        "format": FORMAT,
        "encrypted": cipher is not None,
        "cipher": (type(cipher).__name__ + ":" + cipher._mode
                   if cipher is not None else None),
        "fold_params": fold_params,
        "inputs": [{"shape": list(x.shape), "dtype": _dtype_name(x)}
                   for x in xs],
        "params_file": os.path.basename(params_path) if params_path
        else None,
    }
    with open(path_prefix + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    return path_prefix


def load_inference_model(path_prefix, device=None):
    """-> Predictor (the AnalysisPredictor role)."""
    return Predictor(Config(path_prefix, device=device))


class Config:
    """Predictor config (Paddle's AnalysisConfig): the model's prefix,
    the device to run on (default cuda, through device.resolve;
    EXPORTED: the device the program was traced on), the cipher, and two
    serving knobs mapped onto the bucketed runner (`enable_memory_optim`
    -> donate, `switch_ir_optim(False)` -> exact shapes)."""

    def __init__(self, model_path_prefix=None, device=None):
        self.model_prefix = model_path_prefix
        self.device = device
        self.cipher = None
        self.cipher_key = None
        self.memory_optim = False
        self.ir_optim = True
        self._bound_predictor = None

    def set_model(self, prefix):
        self.model_prefix = prefix

    def set_cipher(self, key, cipher=None):
        """Key (+ cipher, default AES-CTR) of an encrypted model."""
        from .crypto import AESCipher

        self.cipher_key = key
        self.cipher = cipher or AESCipher("CTR")

    def _flag_changed(self, flag: str) -> None:
        pred = self._bound_predictor
        if pred is not None and pred._runner is not None:
            _warn_once(
                f"late:{flag}",
                f"Config.{flag}() called after the predictor warmed its "
                f"first entry: only new Engines built from this predictor "
                f"pick the flag up")

    def enable_memory_optim(self):
        """Release each batch's padded feed on the device right after the
        dispatch (serving.BucketedRunner's `donate`)."""
        self.memory_optim = True
        self._flag_changed("enable_memory_optim")

    def switch_ir_optim(self, flag=True):
        """flag=False runs exact request shapes instead of padded buckets
        (ignored for an export with a fixed batch dim)."""
        self.ir_optim = bool(flag)
        self._flag_changed("switch_ir_optim")


def _traced_device(ep) -> torch.device:
    """The device the exported program's inputs were traced on."""
    for node in ep.graph.nodes:
        val = node.meta.get("val") if node.op == "placeholder" else None
        if isinstance(val, torch.Tensor):
            return val.device
    return torch.device("cpu")


def _param_dtypes(ep, names) -> dict:
    """name -> dtype of the state dict an unfolded export takes first:
    its entries are the program's first inputs, in the dict's order
    (`names`, the order .pdiparams keeps)."""
    sig = set(ep.graph_signature.user_inputs)
    vals = [n.meta["val"] for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in sig]
    return {k: v.dtype for k, v in zip(names, vals)}


class Predictor:
    """ZeroCopyRun-style predictor: load once, then `run()` feeds host
    arrays and fetches host arrays with no per-call graph work."""

    def __init__(self, config):
        prefix = config.model_prefix
        with open(prefix + ".json") as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") != FORMAT:
            raise ValueError(
                f"{prefix}: format {self.manifest.get('format')!r} is not "
                f"{FORMAT!r} (an artifact of the JAX package is StableHLO, "
                f"which this package does not run)")
        with open(prefix + ".pt2", "rb") as f:
            blob = f.read()
        if self.manifest.get("encrypted"):
            if config.cipher_key is None:
                raise ValueError(
                    "encrypted inference model: call "
                    "Config.set_cipher(key) before create_predictor")
            cipher = config.cipher
            mode = (self.manifest.get("cipher") or ":CTR").split(":")[-1]
            if cipher is None or getattr(cipher, "_mode", mode) != mode:
                from .crypto import AESCipher

                cipher = AESCipher(mode)  # the manifest's mode wins
            blob = cipher.decrypt(blob, config.cipher_key)
        self._exported = torch.export.load(io.BytesIO(blob))
        traced = _traced_device(self._exported)
        self.device = _device.resolve(
            traced if config.device == EXPORTED else config.device)
        if (traced.type, traced.index or 0) != (self.device.type,
                                                self.device.index or 0):
            raise RuntimeError(
                f"{prefix}: the program was traced on {traced} and this "
                f"Predictor runs on {self.device}; a traced program's "
                f"constants stay on the device they were made on: export "
                f"it again on {self.device}")
        self._module = self._exported.module()
        self._params = None
        if self.manifest.get("params_file"):
            from ..framework_io import load as pload

            raw = pload(os.path.join(os.path.dirname(prefix),
                                     self.manifest["params_file"]))
            dtypes = _param_dtypes(self._exported, list(raw))
            self._params = {
                k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     dtypes[k])
                for k, v in raw.items()}
        self._config = config
        self._runner = None
        config._bound_predictor = self

    def get_input_names(self):
        return [f"x{i}" for i in range(len(self.manifest["inputs"]))]

    # -- the bucketed serving path -----------------------------------------
    def _traceable_fn(self):
        """The exported program as a callable on device tensors, what the
        serving BucketedRunner runs per bucket (unfolded params ride
        along)."""
        module, params = self._module, self._params
        if params is not None:
            return lambda *xs: list(module(params, *xs))
        return lambda *xs: list(module(*xs))

    def _fixed_batch(self):
        """The export's leading dim, when every input shares one: the
        export is over concrete shapes, so every request is padded up to
        it (and larger ones chunked through it)."""
        shapes = [i["shape"] for i in self.manifest["inputs"]]
        if shapes and all(len(s) >= 1 for s in shapes):
            leads = {s[0] for s in shapes}
            if len(leads) == 1:
                return int(leads.pop())
        return None

    def _bucketed_runner(self):
        if self._runner is None:
            from ..serving.bucketing import BucketedRunner, bucket_ladder

            fixed = self._fixed_batch()
            bucketed = self._config.ir_optim
            if fixed is not None:
                buckets = [fixed]
                if not self._config.ir_optim:
                    _warn_once(
                        "ir_optim_fixed_export",
                        "switch_ir_optim(False) asks for exact shapes, but "
                        "this model was exported with a fixed batch dim: "
                        "requests are padded to it; the flag is ignored "
                        "for this predictor")
                bucketed = True
            else:
                buckets = bucket_ladder(8)
            self._runner = BucketedRunner(
                self._traceable_fn(), buckets, device=self.device,
                donate=self._config.memory_optim, bucketed=bucketed)
        return self._runner

    def _normalize(self, inputs):
        vals = []
        for x, spec in zip(inputs, self.manifest["inputs"]):
            if spec["dtype"] == "bfloat16":
                raise NotImplementedError(
                    "a bfloat16 input: numpy has no bfloat16 to feed it "
                    "as; export with a float32 input and cast inside")
            a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            vals.append(a.astype(spec["dtype"], copy=False))
        return vals

    def run_handles(self, inputs):
        """Run through the bucketed runner -> LazyFetch handles over the
        device tensors (no transfer; materialize at the caller's
        boundary)."""
        from ..fluid.executor import LazyFetch

        vals = self._normalize(inputs)
        if any(v.ndim == 0 for v in vals):
            # no batch dim to bucket over: a direct call
            with torch.inference_mode():
                outs = self._traceable_fn()(
                    *[torch.from_numpy(v).to(self.device) for v in vals])
        else:
            outs = self._bucketed_runner().run(vals)
        return [LazyFetch(o, name=f"fetch{i}") for i, o in enumerate(outs)]

    def run(self, inputs):
        """inputs: arrays in manifest order -> list of numpy outputs
        (bfloat16 widened to float32)."""
        from ..serving.engine import _to_host

        return [_to_host(h.torch()) for h in self.run_handles(inputs)]


def create_predictor(config):
    return Predictor(config)


__all__ = ["Config", "Predictor", "create_predictor",
           "load_inference_model", "save_inference_model"]
