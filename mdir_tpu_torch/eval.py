"""Evaluate a network by following yaml scenarios: the port's counterpart of
``examples/iccv19/eval.py``.

    python -m mdir_tpu_torch.eval [scenario.yml ...] [--artifacts DIR]
    python -m mdir_tpu_torch.eval test | clahe | composition

One argument that is not a ``.yml`` file is a shortcut for the repository's
``examples/iccv19/eval.yml`` overlaid with ``eval_<shortcut>.yml``: ``test``
(AlexNet CLAHE), ``clahe`` (VGG16 CLAHE N/D) and ``composition`` (the U-Net
jointly N/D model). The files are overlaid with ``config.load_scenario``
and run through the validate stage on ``main``'s ``device`` (the card
from the command line); the three score lines of the paper's table are
printed.

Nothing is downloaded. A ``path`` or ``whitening`` in the scenario that is
a URL resolves to ``<artifacts>/<basename>`` with ``--artifacts DIR``, else
to ``<data root>/networks/<basename>``, where the JAX package caches what it
downloads; the sha256 prefix in the name is checked, and a missing file
raises, naming the path to put it at. The test datasets must be on disk
under ``<data root>/test`` (``data/testdata.py``).
"""
import argparse
import os
import sys

from .config.overlay import load_scenario
from .stages.validate import validate
from .tools.utils import resolve_artifact

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "iccv19")
SCORES = {
    "roxford5k/validation/score:ap_medium_avg.4": "roxford.5k medium",
    "rparis6k/validation/score:ap_medium_avg.4": "rparis.6k medium",
    "247tokyo1k/validation/score:ap_avg.4": "247tokyo.1k",
}
_URL_KEYS = ("path", "whitening")


def resolve_urls(node, artifacts=None):
    """The scenario with every URL under a ``path`` or ``whitening`` key
    replaced by its local file."""
    if isinstance(node, list):
        return [resolve_urls(item, artifacts) for item in node]
    if not isinstance(node, dict):
        return node
    out = {}
    for key, value in node.items():
        if key in _URL_KEYS and isinstance(value, str) \
                and value.startswith(("http://", "https://")):
            out[key] = resolve_artifact(value, artifacts)
        else:
            out[key] = resolve_urls(value, artifacts)
    return out


def main(argv=None, device="cuda"):
    parser = argparse.ArgumentParser(
        prog="python -m mdir_tpu_torch.eval",
        description="Evaluate a network by following yaml scenarios.")
    parser.add_argument("scenarios", nargs="*",
                        help="scenario files, or one shortcut: test, clahe, "
                             "composition")
    parser.add_argument("--artifacts", default=None,
                        help="directory holding the files of the scenario's "
                             "URLs (default: <data root>/networks)")
    args = parser.parse_args(argv)

    scenarios = args.scenarios
    if len(scenarios) == 1 and not scenarios[0].endswith(".yml"):
        scenarios = [os.path.join(EXAMPLES, "eval.yml"),
                     os.path.join(EXAMPLES, "eval_%s.yml" % scenarios[0])]
    scenario = load_scenario(scenarios)
    if not scenario:
        sys.stderr.write("Scenario needs to be specified\n")
        return 1

    metadata, = validate(resolve_urls(scenario, args.artifacts), (),
                         device=device)
    for heading, section in metadata.items():
        print("\n%s\n" % heading.capitalize())
        for key, value in section.items():
            if key in SCORES:
                print("    %-20s %s" % (SCORES[key], round(100 * value, 2)))
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
