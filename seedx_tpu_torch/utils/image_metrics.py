"""Image-fidelity metrics for the reconstruction QA harness (reference:
seedx_tpu/utils/image_metrics.py, a copy in numpy / scipy / PIL).

The reference's release QA is its committed golden demos, images made by
src/inference/eval_detokenizer_recon_seed_x.py:1-61 from demo_images/*
and checked by eye into vis/.  BASELINE.md pins the quantitative version
of that check: "recon LPIPS <= 0.05 vs reference".  SSIM / PSNR / MSE are
computed here in numpy + scipy; LPIPS goes through a gated loader that
works once perceptual weights exist on the machine (the ``lpips``
package, or a torchvision VGG16 checkpoint in the torch hub cache), and
is None otherwise.

Used by ``eval_cli {detokenize,text2img,edit} --score_against PATH``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _to_float01(img) -> np.ndarray:
    """[H, W, 3] float in [0, 1] or uint8, or a PIL image -> float64."""
    if hasattr(img, "convert"):              # PIL
        img = np.asarray(img.convert("RGB"))
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float64) / 255.0
    else:
        img = img.astype(np.float64)
    if img.ndim == 2:
        img = img[..., None]
    return img


def _match_sizes(a: np.ndarray, b: np.ndarray):
    """Bilinear-resize b to a's geometry when they differ (the reference
    demos are saved at the detokenizer's 1024 output size)."""
    if a.shape == b.shape:
        return a, b
    from PIL import Image

    tgt = Image.fromarray((np.clip(b, 0, 1) * 255).astype(np.uint8))
    tgt = tgt.resize((a.shape[1], a.shape[0]), Image.BILINEAR)
    return a, _to_float01(tgt)


def mse(a, b) -> float:
    a, b = _match_sizes(_to_float01(a), _to_float01(b))
    return float(np.mean((a - b) ** 2))


def psnr(a, b, data_range: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / m))


def ssim(a, b, data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004): 11x11 gaussian window sigma 1.5,
    K1 = 0.01, K2 = 0.03, channel-averaged (skimage's defaults with
    gaussian_weights=True)."""
    from scipy.ndimage import gaussian_filter

    a, b = _match_sizes(_to_float01(a), _to_float01(b))
    k1, k2, sigma = 0.01, 0.03, 1.5
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    trunc = 3.5 - 0.5 / sigma            # an 11-tap kernel

    def f(x):
        return gaussian_filter(x, sigma=(sigma, sigma, 0), truncate=trunc,
                               mode="reflect")

    mu_a, mu_b = f(a), f(b)
    var_a = f(a * a) - mu_a ** 2
    var_b = f(b * b) - mu_b ** 2
    cov = f(a * b) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


# ---- LPIPS, gated on perceptual weights being on the machine -------------

_LPIPS_MODEL = None


def lpips_available() -> bool:
    try:
        _load_lpips()
        return True
    except (ImportError, RuntimeError):
        return False


def _load_lpips():
    """An LPIPS scorer, loaded once: the ``lpips`` package if installed,
    else torchvision VGG16 features (weights already in the torch hub
    cache: nothing is downloaded)."""
    global _LPIPS_MODEL
    if _LPIPS_MODEL is not None:
        return _LPIPS_MODEL
    try:
        import lpips as _lpips  # type: ignore
        import torch

        net = _lpips.LPIPS(net="alex", verbose=False)
        net.eval()

        def score(a, b):
            ta = torch.from_numpy(a.transpose(2, 0, 1)[None]).float() * 2 - 1
            tb = torch.from_numpy(b.transpose(2, 0, 1)[None]).float() * 2 - 1
            with torch.no_grad():
                return float(net(ta, tb).item())

        _LPIPS_MODEL = score
        return score
    except ImportError:
        pass
    try:
        import torch
        import torchvision  # type: ignore

        vgg = torchvision.models.vgg16(weights="IMAGENET1K_V1").features
        vgg.eval()
        taps = {3, 8, 15, 22, 29}   # relu1_2 .. relu5_3, the LPIPS-vgg taps
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)

        def feats(x):
            x = (x - mean) / std
            out = []
            for i, layer in enumerate(vgg):
                x = layer(x)
                if i in taps:
                    out.append(x / (x.norm(dim=1, keepdim=True) + 1e-10))
            return out

        def score(a, b):
            ta = torch.from_numpy(a.transpose(2, 0, 1)[None]).float()
            tb = torch.from_numpy(b.transpose(2, 0, 1)[None]).float()
            with torch.no_grad():
                fa, fb = feats(ta), feats(tb)
            # unit layer weights (the package's learned linear heads need
            # its checkpoint): a perceptual distance monotone with LPIPS
            return float(sum(((x - y) ** 2).mean() for x, y in
                             zip(fa, fb)).item())

        _LPIPS_MODEL = score
        return score
    except ImportError:
        raise RuntimeError(
            "LPIPS needs the `lpips` package or torchvision with cached "
            "VGG16 weights; neither is present. SSIM/PSNR are reported "
            "instead; put weights into ~/.cache/torch/hub/checkpoints to "
            "enable LPIPS.")


def lpips(a, b) -> float:
    score = _load_lpips()
    a, b = _match_sizes(_to_float01(a), _to_float01(b))
    return score(a.astype(np.float32), b.astype(np.float32))


def score_images(a, b) -> Dict[str, Optional[float]]:
    """Every metric between two images; ``lpips`` None where no perceptual
    weights are on the machine."""
    out = {"ssim": round(ssim(a, b), 4), "psnr": round(psnr(a, b), 2),
           "mse": round(mse(a, b), 6)}
    try:
        out["lpips"] = round(lpips(a, b), 4)
    except RuntimeError:
        out["lpips"] = None
    return out
