"""Stable-Diffusion inpainting stack: UNet, VAE, CLIP text, DDIM and the
adaptive-mask pipeline."""
