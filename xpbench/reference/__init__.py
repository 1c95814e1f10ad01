"""The plain float32 reference of the benchmark: the XPoint models
(``models``), the serving chain's operations (``ops``) and the training
loss with Adam (``train``). It imports torch and numpy only: nothing of
the program under test, and nothing of JAX."""
import torch

from .models import XPoint
from .ops import Prec


def build(model_cfg, precision, state, device, control=None, count=False):
    """The reference model on ``device`` with the parameters and buffers of
    ``state`` (name -> tensor, the program's names), in eval mode, and its
    :class:`Prec` (``precision``: class -> stated precision; ``control``:
    None, "fp8" or "int8", the rounding of the control)."""
    prec = Prec(precision, control=control, count=count)
    with torch.device("meta"):
        model = XPoint(model_cfg, prec)
    model = model.to_empty(device=device)
    if state is not None:
        model.load_state_dict(state, strict=True)
    return model.eval(), prec
