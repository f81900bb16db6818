"""Built-in loaders: the port of kubeflow_tpu/serving/loaders.py.

A loader is ``fn(config, device) -> (variables -> predict)``, where
predict maps {input_name: array} -> {output_name: numpy array}.  Loader
paths are recorded in model.json at export time (serving/export.py).

Only ``lm_generate`` is ported; the ``lm`` loader comes with the rest of
the serving surface (ROADMAP queue 1, item 9) and ``classifier`` with
the CNN family (item 14).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from kubeflow_tpu_torch import NotPortedError
from kubeflow_tpu_torch.device import DeviceLike, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _model_config(overrides: Dict[str, Any]):
    """TransformerConfig from JSON-safe overrides (model.json carries the
    dtype as a string, e.g. "float32"/"bfloat16")."""
    from kubeflow_tpu_torch.models.transformer import TransformerConfig

    overrides = dict(overrides)
    if isinstance(overrides.get("dtype"), str):
        name = overrides["dtype"]
        if name not in _DTYPES:
            raise ValueError(f"unknown model dtype {name!r}")
        overrides["dtype"] = _DTYPES[name]
    return TransformerConfig(**overrides)


def lm_generate(config: Dict[str, Any], device: DeviceLike = None) -> Callable:
    """Autoregressive generation loader.

    config: {"model": TransformerConfig overrides, "max_new_tokens": int,
             "temperature": float, "top_k": int (0 = off),
             "top_p": float (1.0 = off), "eos_token": int}

    Sampling is deterministic per request: a request without ``seed``
    samples from seed 0, so identical prompts return identical
    completions.  Signature: {"tokens": [b, t] int} ->
    {"tokens": [b, t + new] int32}.  ``prompt_len`` ([b]) marks
    left-padded rows; ``max_new_tokens`` trims the completion.

    ``predict.engine_spec`` = {"cfg", "model", "decode"}: the loaded
    ``Transformer`` on its device and its decode settings, from which
    the serving entry point builds the continuous-batching DecodeEngine
    around every hot-swapped version.
    """
    from kubeflow_tpu_torch.models.convert import load_params, params_from_jax
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops.quantize import narrow_params

    dev = resolve_device(device)
    cfg = _model_config(config.get("model", {}))
    for key in ("quantize", "kv_cache"):
        if config.get(key) is not None:
            raise NotPortedError(
                f"{key}={config[key]!r}: int8 serving is not ported yet "
                "(ROADMAP queue 1 item 4)")
    decode = DecodeConfig(
        max_new_tokens=int(config.get("max_new_tokens", 64)),
        temperature=float(config.get("temperature", 0.0)),
        top_k=int(config.get("top_k", 0)),
        top_p=float(config.get("top_p", 1.0)),
        eos_token=int(config.get("eos_token", -1)),
    )

    def make_predict(variables):
        # Staged on the device once, with the matmul weights narrowed to
        # the compute dtype (checkpoints carry float32 masters); norm
        # scales stay float32.
        params = narrow_params(params_from_jax(variables["params"]),
                               cfg.dtype)
        model = load_params(Transformer(cfg, device="meta"), params).to(dev)

        def predict(inputs: Dict[str, Any]) -> Dict[str, Any]:
            tokens = torch.as_tensor(np.asarray(inputs["tokens"]),
                                     dtype=torch.int64)
            seed = inputs.get("seed")
            # One seed per CALL: the bucketed batcher declines seeded
            # requests so they arrive here unbatched.
            generator = torch.Generator(device=dev).manual_seed(
                0 if seed is None else int(np.asarray(seed).reshape(-1)[0]))
            plen = inputs.get("prompt_len")
            if plen is not None:
                plen = torch.as_tensor(np.asarray(plen).reshape(-1))
            out, _ = generate(model, tokens, decode, generator=generator,
                              prompt_len=plen)
            out = out.to(torch.int32).cpu().numpy()
            req = inputs.get("max_new_tokens")
            if req is not None:
                # The program decodes the config's full budget; a smaller
                # per-request budget trims the surplus.  A multi-row call
                # trims to the batch's largest budget.
                lim = int(np.max(np.asarray(req)))
                lim = max(1, min(lim, decode.max_new_tokens))
                out = out[:, : tokens.shape[1] + lim]
            return {"tokens": out}

        predict.engine_spec = {"cfg": cfg, "model": model,
                               "decode": decode}
        return predict

    return make_predict
