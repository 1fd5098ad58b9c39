"""The conversation layer (knowpro) of the PyTorch port; the JAX package's
``typeagent_tpu/knowpro`` is its reference, module for module."""
