"""Host-side utilities of the port: ``tb.SummaryWriter``, the logging shim
behind BiNE's ``logdir`` (imported by its user, so that importing this
package loads no TensorBoard backend)."""
