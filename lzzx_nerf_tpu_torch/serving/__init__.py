from .session import ServingSession
from .state_io import load_trained_state, params_from_jax, params_to_jax

__all__ = ["ServingSession", "load_trained_state", "params_from_jax",
           "params_to_jax"]
