"""InternVL2-style VLM: the InternViT frontend is a STUB, as in the JAX
package (``src/repro/models/vlm.py``): ``batch["prefix_embeds"]`` carries
post-projection patch embeddings (B, n_patches, d_model), prepended to the
token stream of the qwen2-style backbone (``models/transformer.py``).  The
loss counts text positions only.  Decode: the patch embeddings' keys and
values fill the first ``n_patches`` rows of the KV cache, and the engines
offset positions by ``n_patches`` (``serve.engine.prompt_prefix_len``).
"""
from __future__ import annotations

from repro_torch.models import transformer as tf

init = tf.init
forward = tf.forward
loss_fn = tf.loss_fn
cache_init = tf.cache_init
prefill = tf.prefill
decode_step = tf.decode_step
