from .optimizer import Adam, AdamW, Optimizer, adam_update  # noqa: F401

__all__ = ["Optimizer", "Adam", "AdamW", "adam_update"]
