from .serving import build_serving_forward

__all__ = ["build_serving_forward"]
