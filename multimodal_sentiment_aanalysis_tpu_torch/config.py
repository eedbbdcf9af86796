"""Constants shared with the JAX package's ``config.py``."""

# MAHNOB-HCI subject ids of the 24 subjects the reference keeps
DEFAULT_SUBJECT_LISTS = [
    1, 2, 4, 5, 6, 7, 8, 10, 11, 13, 14, 17, 18, 19, 20, 21, 22, 23, 24,
    26, 27, 28, 29, 30,
]
