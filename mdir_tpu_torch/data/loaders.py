"""The host data loader of the train stage, as ``mdir_tpu/data/loaders.py``
computes it, without its prefetch threads: shuffle, batch and collate, on
the calling thread.

The shuffle is ``np.random.shuffle`` on the global numpy RNG, drawn when an
iteration starts, as there: with the same seeds both packages see the same
batches. ``num_workers``, ``pin_memory`` and ``prefetch`` are accepted for
the scenario's sake and ignored (the port starts no thread or process).
"""
import numpy as np


def default_collate(items):
    """Stack numpy arrays of one shape; keep other items as lists."""
    if isinstance(items[0], (tuple, list)):
        return tuple(default_collate(list(x)) for x in zip(*items))
    if isinstance(items[0], np.ndarray) \
            and len({x.shape for x in items}) == 1:
        return np.stack(items)
    return items


def collate_tuples(batch):
    """Keep tuple batches as (list of image lists, list of targets)."""
    return [item[0] for item in batch], [item[1] for item in batch]


class DataLoader:
    """Ordered loader: shuffle, batch, collate."""

    def __init__(self, dataset, batch_size=1, shuffle=False, num_workers=0,
                 drop_last=False, collate_fn=None, pin_memory=False,
                 prefetch=8):
        del num_workers, pin_memory, prefetch  # no threads in the port
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate

    def _batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            batch = order[start:start + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                return
            yield batch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        for batch in list(self._batches()):
            yield self.collate_fn([self.dataset[i] for i in batch])
