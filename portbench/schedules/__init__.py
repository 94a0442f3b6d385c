"""One module a learning-rate schedule, found by the configuration's
`optimizer.scheduler`: `lr_at(opt, it)`, the reference's LR of iteration it."""
