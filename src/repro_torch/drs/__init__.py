"""The resource-management substrate: the cluster datamodel and its array
views, actions, the entitlement waterfills, placement rules with their
correction, the hill-climb migration balancer, and DPM."""
