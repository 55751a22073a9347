"""PyTorch/CUDA port of the KVComp reproduction (``src/repro`` is the JAX
reference it is held against).

Same module paths as ``repro``; this package imports ``torch`` and never
``jax`` or anything of ``repro``.  Entry points (``serve.scheduler.Server``,
``models.model.init_params``, ``models.model.init_decode_state``) run on the
card unless the caller passes ``device="cpu"``, and raise when CUDA is absent.

Float32 products stay float32: TF32 is switched off for matrix products and
cuDNN here, so the port's numbers are comparable with the float32 reference.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
