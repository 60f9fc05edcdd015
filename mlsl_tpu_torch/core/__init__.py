"""Core API objects: Environment, Distribution, Session, Operation, Activation,
ParameterSet and Statistics."""
