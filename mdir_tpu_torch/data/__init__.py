"""Host data: file readers, test and training datasets, the loader,
transforms, image loading and the infer stage's outputs."""
