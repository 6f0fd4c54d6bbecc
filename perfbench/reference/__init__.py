"""The plain reference: float32 PyTorch, no kernels of the program.

``ops`` holds the precision of the convolutions and matrix products (float32
with TF32 off, or the control: operands rounded to float8 e4m3);
``rounds`` holds the MD-GAN and standalone rounds and Adam.  The models are
the family modules beside the configurations (``perfbench/configs/<family>.py``).
"""
