"""int8 sidecar parameters + packed feature transport for EMSNet.

Two artifacts of the quantized glass tier, as in
``repro.models.quantized``:

  * **Sidecar parameter dicts** — ``quantize_emsnet_params`` derives,
    once per float32 dict, a structurally parallel dict where every
    GEMM-heavy dense weight (text ``wqkv``/``wo``/``w1``/``w2``, vitals
    ``wx``, scene ``fc``) is replaced by its int8 per-output-channel form
    ``{"w_q", "w_scale"(, "b")}``. Everything else — embeddings,
    layernorms, the recurrent ``wh``, the fusion heads, the biases — is
    the SAME tensor object as in the source dict (``is`` holds), so
    nothing doubles in memory but the int8 weights. ``layers.dense``
    dispatches on the sidecar form, so the unmodified encoder functions
    run the quantized math when handed a sidecar dict.
  * **Packed features** — ``quantize_feature`` packs a (B, d) float32
    feature into ``{"q": int8 (B, d), "scale": float32 (B, 1)}``, the
    wire form (d + 4 bytes a row); the consuming tier calls
    ``dequantize_feature`` before fusion.
"""
from __future__ import annotations

from ..kernels.ops import dequantize_rowwise, quantize_colwise, quantize_rowwise

__all__ = ["quantize_dense_params", "quantize_emsnet_params",
           "quantize_feature", "dequantize_feature",
           "is_quantized_feature"]

# the dense projections inside one BERT block that carry the FLOPs
_TEXT_DENSE = ("wqkv", "wo", "w1", "w2")


def quantize_dense_params(p):
    """float32 ``{"w"(, "b")}`` -> int8 sidecar ``{"w_q", "w_scale"(, "b")}``."""
    wq, sw = quantize_colwise(p["w"])
    out = {"w_q": wq, "w_scale": sw}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_emsnet_params(params):
    """Derive the int8 sidecar dict from a full EMSNet float32 dict.
    Deterministic — call it once and share the result."""
    q = {}
    for name, sub in params.items():
        if name == "text":
            q[name] = {**sub, "blocks": [
                {**blk, **{k: quantize_dense_params(blk[k])
                           for k in _TEXT_DENSE}}
                for blk in sub["blocks"]]}
        elif name == "vitals":
            q[name] = {**sub, "wx": quantize_dense_params(sub["wx"])}
        elif name == "scene":
            q[name] = {**sub, "fc": quantize_dense_params(sub["fc"])}
        else:
            # heads (and anything unrecognised) stay float32, shared
            q[name] = sub
    return q


def quantize_feature(f):
    """Pack a (B, d) float32 feature into the int8 wire form."""
    qv, s = quantize_rowwise(f)
    return {"q": qv, "scale": s}


def is_quantized_feature(f) -> bool:
    return isinstance(f, dict) and set(f) == {"q", "scale"}


def dequantize_feature(f):
    """Unpack the wire form back to float32; identity on raw features."""
    if not is_quantized_feature(f):
        return f
    return dequantize_rowwise(f["q"], f["scale"])
