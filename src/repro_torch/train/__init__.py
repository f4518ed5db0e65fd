from repro_torch.train.step import loss_fn, make_train_step, train_step  # noqa: F401
