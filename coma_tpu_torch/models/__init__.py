"""Models of the 2D generation stage: the Stable-Diffusion inpainting stack
and the in-loop person segmenter, with Flax's mixed-precision layers."""
