from .optimizer import (Adafactor, Adam, AdamW, Optimizer,  # noqa: F401
                        adam_update)

__all__ = ["Optimizer", "Adam", "AdamW", "Adafactor", "adam_update"]
