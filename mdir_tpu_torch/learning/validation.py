"""Validation tasks of the validate stage (the yaml surface of
``mdir_tpu/learning/validation.py``): ``SingleValidation`` with a score
criterion (``data: null``) and ``MultiCriterialValidation`` over named
validations, with ``network_overlay`` wrapper swaps and ``frequency``
gating. Validation with a loss over a loader comes with the training slice.
"""
import copy

from ..optim.scores import initialize_score
from ..tools.utils import get_dataset_params


class NoValidation:

    decisive_criterion = ""

    def validations(self, _epoch):
        return []


class ScoreValidation:
    """Loader-less validation: a score callable taking (network, logger)."""

    decisive_criterion = "val/learning/score:total"

    def __init__(self, score, network_overlay, frequency):
        self.criterion = score
        self.network_overlay = network_overlay
        self.frequency = frequency

    def should_validate(self, epoch):
        if epoch is None:
            return True
        return bool(self.frequency) and (epoch + 1) % self.frequency == 0

    def validations(self, epoch):
        return [("val", self)] if self.should_validate(epoch) else []

    def validate(self, network, logger=None):
        network = network.overlay_params(copy.deepcopy(self.network_overlay))
        network.eval()
        return self.criterion(network, logger)


class SingleValidation:
    """Yaml-facing factory of a score validation."""

    @classmethod
    def initialize(cls, params, data, params_data, default_criterion,
                   net_defaults):
        data_key = params.pop("data")
        criterion_section = params.pop("criterion")
        schedule = {"network_overlay": params.pop("network_overlay"),
                    "frequency": params.pop("frequency")}
        assert not params, params.keys()
        if data_key is not None:
            raise NotImplementedError(
                "validation with a loss over a loader is not ported yet")
        if criterion_section == "default":
            if default_criterion is None:
                raise ValueError("Criterion cannot be 'default' when default "
                                 "criterion is not specified")
            score = default_criterion
        else:
            score = initialize_score(
                get_dataset_params(criterion_section, net_defaults))
        return ScoreValidation(score, **schedule)


class MultiCriterialValidation:

    def __init__(self, decisive_criterion, validations):
        self.decisive_criterion = decisive_criterion
        self.vals = validations

    @classmethod
    def initialize(cls, params, **kwargs):
        decisive_criterion = params.pop("decisive_criterion")
        named = {key: initialize_validation(scenario, **kwargs)
                 for key, scenario in params.items()}
        return cls(decisive_criterion, named)

    def validations(self, epoch):
        return [(key, val) for key, val in self.vals.items()
                if val.should_validate(epoch)]


VALIDATIONS = {
    "SingleValidation": SingleValidation,
    "MultiCriterialValidation": MultiCriterialValidation,
}


def initialize_validation(params, **kwargs):
    if isinstance(params, bool) and not params:
        return NoValidation()
    return VALIDATIONS[params.pop("type")].initialize(params, **kwargs)
