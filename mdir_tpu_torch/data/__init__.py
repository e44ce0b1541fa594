"""Host data: file readers, test and training datasets, the loader,
transforms and image loading."""
