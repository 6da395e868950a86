"""Loss terms of every pipeline variant (port of
``satnerf_tpu/train/losses.py``).

Each function returns ``(scalar_loss, dict_of_terms)``; the epoch gates are
applied by the caller (``train/step.py``) as multiplier masks.
"""

from __future__ import annotations

import torch

BETA_MIN = 0.05


def mse(pred, gt):
    return torch.mean((pred - gt) ** 2)


def psnr(pred, gt):
    return -10.0 * torch.log10(mse(pred, gt))


# -- rgb losses -------------------------------------------------------------


def nerf_loss(results, gt_rgb):
    """Plain MSE."""
    loss_dict = {"coarse_color": mse(results["rgb"], gt_rgb)}
    return sum(loss_dict.values()), loss_dict


def solar_correction_terms(results, lambda_sc: float):
    """Shadow-NeRF solar-correction terms: term2 pulls the sun visibility to
    the (detached) transmittance along the solar ray, term3 pushes the
    weighted sun visibility to integrate to 1. Under a strided sc ladder
    term2 is rescaled to the full ladder's sample count."""
    sun_sc = results["sun_sc"][..., 0]  # (B, S_sc)
    t_sc = results["transparency_sc"].detach()
    w_sc = results["weights_sc"].detach()
    term2 = torch.sum((t_sc - sun_sc) ** 2, dim=-1)
    n_main = results["weights"].shape[-1]
    if sun_sc.shape[-1] != n_main:
        term2 = term2 * (n_main / sun_sc.shape[-1])
    term3 = 1.0 - torch.sum(w_sc * sun_sc, dim=-1)
    return {
        "coarse_sc_term2": lambda_sc / 3.0 * torch.mean(term2),
        "coarse_sc_term3": lambda_sc / 3.0 * torch.mean(term3),
    }


def snerf_loss(results, gt_rgb, lambda_sc: float = 0.05, sc_enabled: bool = True):
    """MSE + solar correction."""
    loss_dict = {"coarse_color": mse(results["rgb"], gt_rgb)}
    if lambda_sc > 0 and sc_enabled:
        loss_dict.update(solar_correction_terms(results, lambda_sc))
    return sum(loss_dict.values()), loss_dict


def composited_beta(results, beta_key: str = "beta", detach_samples: bool = False):
    """beta composited along the ray + the beta_min floor. ``detach_samples``
    stops the gradient through the beta samples only (the weights keep it)."""
    w = results["weights"]
    beta = results[beta_key]
    if detach_samples:
        beta = beta.detach()
    return torch.sum(w[..., None] * beta, dim=-2) + BETA_MIN


def uncertainty_aware_loss(results, gt_rgb):
    """SatNeRF transient-uncertainty RGB loss."""
    beta = composited_beta(results)  # (B, 1)
    color = torch.mean((results["rgb"] - gt_rgb) ** 2 / (2.0 * beta**2))
    logbeta = (3.0 + torch.mean(torch.log(beta))) / 2.0
    return {"coarse_color": color, "coarse_logbeta": logbeta}


def satnerf_loss(results, gt_rgb, lambda_sc: float = 0.0, sc_enabled: bool = True):
    """Uncertainty-aware + solar correction."""
    loss_dict = dict(uncertainty_aware_loss(results, gt_rgb))
    if lambda_sc > 0 and sc_enabled:
        loss_dict.update(solar_correction_terms(results, lambda_sc))
    return sum(loss_dict.values()), loss_dict


# -- depth supervision ------------------------------------------------------


def depth_loss(results, target_depths, weights=1.0, lambda_ds: float = 1.0):
    """Weighted MSE of rendered depth against tie-point depth (lambda_ds/3)."""
    per_ray = (results["depth"] - target_depths) ** 2
    loss_dict = {"coarse_ds": (lambda_ds / 3.0) * torch.mean(weights * per_ray)}
    return sum(loss_dict.values()), loss_dict


# -- semantic losses --------------------------------------------------------


def _masked_ce(logits, targets, mask):
    """Cross entropy averaged over the masked rays (torch ignore_index
    semantics: excluded rays do not count in the mean)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, targets[:, None].to(torch.int64))[:, 0]
    count = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(ce * mask) / count


def _semantic_mask(targets, ignore_mask, car_index: int, ignore_car: bool):
    mask = torch.ones(targets.shape[0], dtype=torch.float32, device=targets.device)
    if ignore_mask is not None:
        mask = mask * ignore_mask.to(torch.float32)
    if ignore_car and car_index >= 0:
        mask = mask * (targets != car_index).to(torch.float32)
    return mask


def semantic_loss(results, targets, ignore_mask=None, lambda_s: float = 0.04,
                  car_index: int = -1, ignore_car: bool = True):
    """lambda_s * CE(composited logits, labels) with car/sparsity masking."""
    targets = targets.reshape(-1).to(torch.int32)
    mask = _semantic_mask(targets, ignore_mask, car_index, ignore_car)
    ce = _masked_ce(results["semantic_logits"], targets, mask)
    loss_dict = {"coarse_semantic": lambda_s * ce}
    return sum(loss_dict.values()), loss_dict


def semantic_uncertainty_loss(results, targets, ignore_mask=None,
                              lambda_s: float = 0.04, car_index: int = -1,
                              ignore_car: bool = True, detach_beta: bool = False):
    """Uncertainty-weighted CE: the scalar CE scaled by the mean of
    1/(2 beta^2) over all rays; the logbeta term only with a separate
    semantic beta head."""
    targets = targets.reshape(-1).to(torch.int32)
    mask = _semantic_mask(targets, ignore_mask, car_index, ignore_car)
    has_beta_s = "beta_semantic" in results
    beta_key = "beta_semantic" if has_beta_s else "beta"
    beta = composited_beta(results, beta_key, detach_samples=detach_beta)
    ce = _masked_ce(results["semantic_logits"], targets, mask)
    loss_dict = {"coarse_semantic": lambda_s * torch.mean(ce / (2.0 * beta**2))}
    if has_beta_s:
        loss_dict["coarse_semantic_logbeta"] = lambda_s * (
            (3.0 + torch.mean(torch.log(beta))) / 2.0
        )
    return sum(loss_dict.values()), loss_dict


def semantic_car_reg_loss(results, targets, ignore_mask=None, lambda_c: float = 0.1,
                          car_label: int = 4):
    """Transient regularisation: push the composited uncertainty to 1 at rays
    labelled 'car', with a count-safe masked mean (0 when there is none)."""
    targets = targets.reshape(-1)
    uncertainty = torch.sum(results["weights"][..., None] * results["beta"], dim=-2)[:, 0]
    car_mask = (targets == car_label).to(torch.float32)
    if ignore_mask is not None:
        car_mask = car_mask * ignore_mask.to(torch.float32)
    count = torch.clamp(torch.sum(car_mask), min=1.0)
    mse_at_cars = torch.sum(car_mask * (uncertainty - 1.0) ** 2) / count
    loss_dict = {"coarse_car_reg_loss": lambda_c * mse_at_cars}
    return sum(loss_dict.values()), loss_dict
