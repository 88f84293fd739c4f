from repro_torch.models.registry import (ModelApi, decode_batch_shapes,
                                         get_model, make_concrete_batch,
                                         prefill_batch_shapes,
                                         train_batch_shapes)

__all__ = ["ModelApi", "decode_batch_shapes", "get_model",
           "make_concrete_batch", "prefill_batch_shapes",
           "train_batch_shapes"]
