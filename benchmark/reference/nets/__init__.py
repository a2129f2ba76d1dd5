"""Plain backbones, one file each, named by a configuration's `basenet`.

`reference.model` loads `nets/<basenet>.py` by that name. Each file is
plain float32 `torch`, imports nothing of the port, and gives:

- `specs(cfg, out)`: appends the backbone's state-dict entries to
  `out` (a `model.Specs`) in the port's key names and in the order the
  weights are drawn;
- `feat_dim(cfg)`: the width of the per-stack features the heads read;
- `ends_branch(key)`: whether a BatchNorm scale (`...weight`) ends a
  residual branch, so that `init_residual_gain` scales it;
- `backbone(net, x)`: NCHW fp32 images -> the per-stack features, written
  in the `model.PlainPoseNet` layers `net.conv` (the float8 control's
  rounding inside), `net.bn` (BatchNorm calibration inside) and
  `net.linear`.
"""
