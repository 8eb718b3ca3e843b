"""Thin alias so trainer code imports VAE loading from one obvious place."""

from .weight_import import load_vae_params, vae_params_from_diffusers

__all__ = ["load_vae_params", "vae_params_from_diffusers"]
