from repro_torch.models.registry import (ModelApi, get_model,
                                         make_concrete_batch,
                                         train_batch_shapes)

__all__ = ["ModelApi", "get_model", "make_concrete_batch",
           "train_batch_shapes"]
