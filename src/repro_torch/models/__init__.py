from repro_torch.models.registry import ModelApi, get_model

__all__ = ["ModelApi", "get_model"]
