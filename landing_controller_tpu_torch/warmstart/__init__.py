"""Cold-start guesses: reference, ballistic and the learned NN warm start."""
