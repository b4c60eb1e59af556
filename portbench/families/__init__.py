"""Systems under test, one module a model family (a configuration's
`family`). Each `build(config, traffic, seed, device)` returns an object
that the drivers run (`portbench/drivers/`) and that decides `correct`
against the plain reference (`portbench/reference/`)."""
