"""The port's Mask R-CNN with `ChannelMapperWithPooling`
(`neck_type="channel_mapper"`) against the JAX package's at
inference, on the CPU: the checks of `det_model_checks.py` (stage by
stage, fp32 within 2e-4 of scale, kept indices equal with their margins
asserted; the `convert_detector_checkpoint` round trip bitwise)."""

import pytest
import torch

from det_model_checks import build_pair, check_inference, check_round_trip


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The test workers share the host's cores (see test_torch_upernet)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return build_pair("channel_mapper")


def test_mask_rcnn_inference_matches_jax(models):
    check_inference(models)


def test_weight_round_trip_through_convert_detector_checkpoint(models):
    check_round_trip(models)
