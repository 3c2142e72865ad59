from .lstm_gates import fused_lstm_gates, lstm_gates_backward_reference, lstm_gates_reference
from .pixel_shuffle import pixel_shuffle

__all__ = ["fused_lstm_gates", "lstm_gates_backward_reference", "lstm_gates_reference",
           "pixel_shuffle"]
