"""Networks, wrappers, checkpoint reading and validation of the eval path."""
from .checkpoints import Checkpoints
from .network import initialize_network


def load_network(params, device="cuda"):
    """Network from ``params["path"]`` (a checkpoint file or directory) with
    ``params["runtime"]`` applied, on ``device``."""
    state = Checkpoints.load_network(params["path"])
    return initialize_network(state, device, params["runtime"])
