"""A part a launched rank runs for ``test_torch_device_cache.py``. It
imports torch and the port only, never JAX, as ``dryrun.py``'s parts."""
from mdir_tpu_torch.learning.network import initialize_network
from mdir_tpu_torch.optim.scores import initialize_score
from mdir_tpu_torch.parallel.device_cache import shared_cache


def score_and_cache(score, state, *, device):
    """The score section ``score`` of the network of checkpoint ``state``
    on this rank, and the stats of the rank's shared device cache."""
    averages = initialize_score(dict(score))(
        initialize_network(None, device, state))
    return averages, shared_cache(device, score["device_cache_mb"]).stats()
