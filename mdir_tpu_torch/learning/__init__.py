"""Networks, wrappers, checkpoints, validation and the training session."""
from .checkpoints import Checkpoints
from .network import initialize_network


def load_network(params, device="cuda"):
    """Network from ``params["path"]`` (a checkpoint file or directory) with
    ``params["runtime"]`` applied, on ``device``."""
    state = Checkpoints.load_network(params["path"])
    return initialize_network(None, device, state, params["runtime"])


def initialize_learning(params, data, device="cuda"):
    """The training session of a train-stage scenario, on ``device``."""
    from .learning import LEARNINGS

    return LEARNINGS[params["learning"]["type"]].initialize(params, data,
                                                            device)
