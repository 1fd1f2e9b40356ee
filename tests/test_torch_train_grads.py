"""The port's loss and grads against the reference's for the first five reduced
configs in sorted order (tests/_torch_train.py says how and to what
tolerance; the ten are split over two files to keep each short)."""
import pytest

from _torch_train import NAMES, check_loss_and_grads


@pytest.mark.parametrize("name", NAMES[:5])
def test_reduced_model_loss_and_grads(name):
    check_loss_and_grads(name)
