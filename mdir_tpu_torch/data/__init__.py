"""Host data of the eval path: file readers, test datasets, transforms and
image loading."""
