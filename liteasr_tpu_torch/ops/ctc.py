"""CTC loss on logits (liteasr_tpu/ops/ctc.py:ctc_loss_logits).

The JAX package runs the CTC forward recursion as XLA code (a ``lax.scan``
over the (B, 2U+1) lattice), not as a Pallas kernel; the port takes
``torch.nn.functional.ctc_loss`` on an fp32 log-softmax, the same function.
An infeasible row (fewer frames than labels plus repeats) has no lattice
path: torch gives it +inf, and inf * 0 = NaN would poison the step, so
``zero_infinity=True`` makes it 0 (and its gradient 0); the criterion also
weights such rows by 0 explicitly, as the reference does.
"""

import torch
import torch.nn.functional as F


def ctc_loss_logits(logits: torch.Tensor, targets: torch.Tensor,
                    input_lengths: torch.Tensor, label_lengths: torch.Tensor,
                    blank: int = 0) -> torch.Tensor:
    """Per-utterance negative log-likelihood, shape (B,).

    :param logits: (B, T, V) pre-softmax scores, any float dtype
    :param targets: (B, U) label ids; positions past ``label_lengths`` are
        ignored
    :param input_lengths: (B,) valid frames; ``label_lengths``: (B,)
    """
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    return F.ctc_loss(log_probs, targets.long(), input_lengths.long(),
                      label_lengths.long(), blank=blank, reduction="none",
                      zero_infinity=True)
