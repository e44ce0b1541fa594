"""The training session (``TrainValLearning``), as
``mdir_tpu/learning/learning.py``: a network, its epoch loop, the
validations, the event broker and the resource statistics, opened fresh or
restored from the latest checkpoint under ``<directory>/epochs``, iterated
as ``Epoch(epoch, train, vals)`` and checkpointed at each epoch's close. The
checkpoint payload is ``{training, validation, datasets, events,
resources}`` beside the network files. The event broker writes its blobs
and report under the checkpoints' ``epochs`` directory. In a process group
only rank 0 writes (``parallel/mesh.py::writes_files``); every rank takes
the session's state, which gathers a sharded optimizer's.
"""
import copy
from collections import namedtuple

from ..parallel.mesh import writes_files
from ..tools.events import initialize_processor
from ..tools.stats import CodeVersion, ResourceUsage
from .checkpoints import Checkpoints
from .network import initialize_network
from .resume import check_session_consistency
from .training import initialize_training
from .validation import initialize_validation

Epoch = namedtuple("Epoch", ["epoch", "train", "vals"])


def _check_scenario_shape(params):
    """The scenario's sections, strictly (typos fail loudly)."""
    learning = params.get("learning", {})
    if params.keys() != {"network", "learning", "output", "data"} \
            or learning.get("type") != TrainValLearning.__name__ \
            or learning.keys() != {"type", "checkpoints", "training",
                                   "validation"}:
        raise ValueError(
            "a train scenario has network, learning (type TrainValLearning: "
            "checkpoints, training, validation), output and data; got %s, "
            "learning %s" % (sorted(params), sorted(learning)))


def _open_session(params, data, device):
    """Restore from the latest checkpoint if there is one, else start."""
    checkpoints = Checkpoints(**params["learning"]["checkpoints"])
    # JAX's "<directory>/../epochs"; none but rank 0's writes
    events_root = checkpoints.directory if writes_files() else None
    saved = checkpoints.load_latest_epoch(
        params["learning"]["training"]["epochs"])

    if saved is None:
        network = initialize_network(params["network"], device)
        events = initialize_processor(params["output"]["learning"],
                                      events_root)
        resources = ResourceUsage.initialize()
        training = initialize_training(params["learning"]["training"],
                                       network, data, params["data"])
    else:
        net_state, train_stats = saved
        check_session_consistency(train_stats, params)
        network = initialize_network(params["network"], device, net_state)
        events = initialize_processor(params["output"]["learning"],
                                      events_root, train_stats["events"])
        resources = ResourceUsage.initialize_from_state(
            train_stats["resources"])
        training = initialize_training(params["learning"]["training"],
                                       network, data, params["data"],
                                       state=train_stats["training"])
    validation = initialize_validation(
        params["learning"]["validation"], data=data,
        params_data=params["data"], default_criterion=training.criterion,
        net_defaults=network.network_params.runtime.get("data", {}))
    return {"network": network, "training": training,
            "validation": validation, "events": events,
            "resources": resources, "checkpoints": checkpoints}


class TrainValLearning:
    """Iterable session yielding ``Epoch(epoch, train, vals)`` per epoch."""

    def __init__(self, params, network, training, validation, events,
                 resources, checkpoints):
        self.params = params
        self.network = network
        self.training = training
        self.validation = validation
        self.events = events
        self.resources = resources
        self.checkpoints = checkpoints
        self.code_version = CodeVersion()

    @classmethod
    def initialize(cls, params, data, device="cuda"):
        declared = copy.deepcopy(params)
        _check_scenario_shape(params)
        return cls(declared, **_open_session(params, data, device))

    def close_epoch(self):
        """Close the epoch's events, then checkpoint everything."""
        self.events.close_epoch()
        decisive = self.validation.decisive_criterion
        payload = self._session_payload()  # a collective under ZeRO
        if writes_files():
            self.checkpoints.save_epoch(
                self.network.state_dict(), payload, self.training.epoch,
                self.events.metadata.is_last_best(decisive),
                not self.training.remains_epochs)

    def _session_payload(self):
        """What a resume needs beside the network's weights."""
        scenario = self.params
        return {"training": self.training.state_dict(),
                "validation": {"params": scenario["learning"]["validation"]},
                "datasets": scenario["data"],
                "events": self.events.state_dict(),
                "resources": self.resources.state_dict()}

    @property
    def metadata(self):
        keeper = self.events.metadata
        decisive = self.validation.decisive_criterion
        return {
            "metrics": keeper.metadata(),
            "best_epoch": keeper.best_epoch(decisive),
            "resource_usage": self.resources.get_resources(),
            "code_version": self.code_version.versions,
        }

    def __iter__(self):
        return self

    def __next__(self):
        epoch, steps = next(self.training)
        return Epoch(epoch=epoch, train=steps,
                     vals=self.validation.validations(epoch))


LEARNINGS = {
    "TrainValLearning": TrainValLearning,
}
