"""Built-in loaders: the port of kubeflow_tpu/serving/loaders.py.

A loader is ``fn(config, device) -> (variables -> predict)``, where
predict maps {input_name: array} -> {output_name: numpy array}.  Loader
paths are recorded in model.json at export time (serving/export.py).

All three of the JAX package's loaders are ported: ``lm`` (logits),
``lm_generate`` and ``classifier``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

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


def classifier(config: Dict[str, Any], device: DeviceLike = None
               ) -> Callable:
    """Image classifier over models/resnet.py or models/inception.py.

    config: {"family": "resnet50"|"inception_v3"|..., "num_classes": int,
             "top_k": int (5), "num_filters": int (resnet, 64)}
    Signature: {"image": [b, h, w, 3] or [h, w, 3], float or uint8} ->
               {"scores": [b, classes], "top_k_scores": [b, k],
                "top_k_classes": [b, k]}

    The model computes in bfloat16, as the JAX loader's does, and is
    staged on the device once per version, its conv kernels narrowed to
    bf16 there (BatchNorm and head stay float32).  The wire dtype is kept
    on the host-to-device copy and converted on the device: uint8 images
    (the raw-image-bytes contract) are scaled to [0, 1] there, a quarter
    of the bytes of a host-side float32 cast.  float64 is narrowed to
    float32 on the host; integer pixels ship as uint8 when they fit
    0..255, else as float32 (unscaled).  A 3-dim image gets a batch
    axis.  The top k is a stable descending sort of the scores, so ties
    go to the lowest class, as ``jax.lax.top_k`` breaks them.

    ``predict.model`` and ``predict.batch_stats`` are the staged model and
    its running statistics, for callers that hold the served numbers to
    a direct run.
    """
    from kubeflow_tpu_torch.models.convert_cnn import load_cnn_variables

    dev = resolve_device(device)
    family = config.get("family", "resnet50")
    num_classes = int(config.get("num_classes", 1000))
    top_k = min(int(config.get("top_k", 5)), num_classes)
    if family.startswith("resnet"):
        from kubeflow_tpu_torch.models.resnet import ResNetConfig

        factory = ResNetConfig._FACTORIES.get(family)
        if factory is None:
            raise ValueError(f"unknown resnet family {family!r}")

        def build():
            return factory(num_classes=num_classes,
                           num_filters=int(config.get("num_filters", 64)),
                           device=dev)
    elif family == "inception_v3":
        from kubeflow_tpu_torch.models.inception import InceptionV3

        def build():
            return InceptionV3(num_classes=num_classes, device=dev)
    else:
        raise ValueError(f"unknown classifier family {family!r}")

    def make_predict(variables):
        model = build()
        batch_stats = load_cnn_variables(model, variables)
        model.requires_grad_(False)
        for p in model.parameters():
            if p.dim() == 4:  # conv kernels: the compute dtype, once
                p.data = p.data.to(model.dtype).contiguous(
                    memory_format=torch.channels_last)

        @torch.inference_mode()
        def fwd(image: torch.Tensor):
            image = image.to(dev, non_blocking=True)
            if image.dtype == torch.uint8:
                image = image.to(torch.float32) / 255.0
            else:
                image = image.to(torch.float32)
            logits = model(image, batch_stats)
            probs = torch.softmax(logits, dim=-1)
            top_p, top_i = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
            return probs, top_p[:, :top_k], top_i[:, :top_k]

        def predict(inputs: Dict[str, Any]) -> Dict[str, Any]:
            image = inputs["image"]
            if not isinstance(image, torch.Tensor):
                image = np.asarray(image)
                if image.dtype == np.float64:
                    image = image.astype(np.float32)
                elif image.dtype.kind in "iu" and image.dtype != np.uint8:
                    # JSON integer pixels: uint8 when they fit the 0..255
                    # image range, else float32.
                    if image.size and 0 <= image.min() \
                            and image.max() <= 255:
                        image = image.astype(np.uint8)
                    else:
                        image = image.astype(np.float32)
                image = torch.from_numpy(np.ascontiguousarray(image))
            if image.dim() == 3:
                image = image[None]
            probs, top_p, top_i = fwd(image)
            return {"scores": probs.cpu().numpy(),
                    "top_k_scores": top_p.cpu().numpy(),
                    "top_k_classes": top_i.to(torch.int32).cpu().numpy()}

        predict.model = model
        predict.batch_stats = batch_stats
        return predict

    return make_predict


def lm(config: Dict[str, Any], device: DeviceLike = None) -> Callable:
    """Transformer LM loader: next-token logits for a token batch.

    config: TransformerConfig field overrides (not nested under "model",
            unlike ``lm_generate``'s).
    Signature: {"tokens": [b, s] int} -> {"logits": [b, s, vocab] float32}

    The weights are narrowed to the compute dtype and staged on the
    device once per version, as ``lm_generate``'s are.  The forward is
    the port's ``Transformer``: with ``attention: "flash"`` its causal
    prefill launches the flash forward kernel on CUDA (one launch a
    layer) and runs the kernel's plain version on the CPU.  The logits
    are float32 whatever the model's ``ce_dtype``.  ``predict.model`` is
    the staged model and ``predict.forward`` the device-side call
    (tokens tensor -> float32 logits on the device), for callers that
    time or check the forward apart from the copy to the host.
    ``predict`` refuses token ids outside ``[0, vocab_size)`` with a
    ValueError before anything reaches the device.
    """
    from kubeflow_tpu_torch.models.convert import (
        load_params,
        params_from_jax,
        params_to_device,
    )
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops.quantize import narrow_params

    dev = resolve_device(device)
    cfg = _model_config(config)

    def make_predict(variables):
        params = narrow_params(params_from_jax(variables["params"]),
                               cfg.dtype)
        model = load_params(Transformer(cfg, device="meta"),
                            params_to_device(params, dev))
        model.requires_grad_(False)

        @torch.inference_mode()
        def forward(tokens: torch.Tensor) -> torch.Tensor:
            return model(tokens.to(dev, non_blocking=True)).to(
                torch.float32)

        def predict(inputs: Dict[str, Any]) -> Dict[str, Any]:
            tokens = np.asarray(inputs["tokens"])
            # Checked on the host: an id outside the table would trip a
            # device-side assert in the embedding gather, and that error
            # sticks to the process's CUDA context, failing every model
            # the server holds.  A ValueError answers 400.
            if tokens.size and (tokens.min() < 0
                                or tokens.max() >= cfg.vocab_size):
                raise ValueError(
                    f"token ids must lie in [0, {cfg.vocab_size}): got "
                    f"[{tokens.min()}, {tokens.max()}]")
            tokens = torch.as_tensor(tokens, dtype=torch.int64)
            return {"logits": forward(tokens).cpu().numpy()}

        predict.model = model
        predict.forward = forward
        return predict

    return make_predict


def lm_generate(config: Dict[str, Any], device: DeviceLike = None) -> Callable:
    """Autoregressive generation loader.

    config: {"model": TransformerConfig overrides, "max_new_tokens": int,
             "temperature": float, "top_k": int (0 = off),
             "top_p": float (1.0 = off), "eos_token": int,
             "quantize": "int8" (optional, weight-only),
             "kv_cache": "int8" (optional, quantized decode cache)}

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
    from kubeflow_tpu_torch.models.convert import (
        load_params,
        params_from_jax,
        params_to_device,
    )
    from kubeflow_tpu_torch.models.generate import DecodeConfig, generate
    from kubeflow_tpu_torch.models.transformer import Transformer
    from kubeflow_tpu_torch.ops.quantize import narrow_params, quantize_params

    dev = resolve_device(device)
    cfg = _model_config(config.get("model", {}))
    kv_cache = config.get("kv_cache")
    if kv_cache not in (None, "int8"):
        raise ValueError(f"unknown kv_cache mode {kv_cache!r}")
    decode = DecodeConfig(
        max_new_tokens=int(config.get("max_new_tokens", 64)),
        temperature=float(config.get("temperature", 0.0)),
        top_k=int(config.get("top_k", 0)),
        top_p=float(config.get("top_p", 1.0)),
        eos_token=int(config.get("eos_token", -1)),
        kv_cache_dtype=kv_cache or "model",
    )
    quantize = config.get("quantize")
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")

    def make_predict(variables):
        # Staged on the device once.  Weight-only int8 quantization runs
        # on the host before the copy, so the int8 bytes are what cross
        # to the device and live there; without it the matmul weights
        # are narrowed to the compute dtype (checkpoints carry float32
        # masters).  Norm scales stay float32 either way.
        params = params_from_jax(variables["params"])
        if quantize == "int8":
            params = quantize_params(params)
        else:
            params = narrow_params(params, cfg.dtype)
        model = load_params(Transformer(cfg, device="meta"),
                            params_to_device(params, dev))

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
