"""Models: the Stable-Diffusion inpainting stack and the in-loop person
segmenter of the 2D generation stage, with Flax's mixed-precision layers; and
the SMPL-X body model (LBS) of the ComA learning stage."""
